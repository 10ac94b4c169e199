"""MLA's latent caches in the port's paged pool and host tier against the
JAX reference at deepseek-v3's smoke geometry, on the CPU.

The pool's store is ``model.init_cache(N, block_size)``: one
``LatentCache`` per MLA layer whose one ``(N, bs, r + rope)`` buffer
stands for the reference's ``ckv`` and ``krope`` leaves.  Checked: gather
(holes read as pos -1 and a zero latent), scatter and the COW copy move the
reference's numbers and keep the ``LatentCache`` type and rank; ``serve``
gives the reference's tokens, steps and prefix stats (dense attention,
staged QUOKA, g = 16 blocks), a prefix hit and a copy-on-write tail over
latent blocks, and each request's own ``generate``; the host tier packs a
latent slab as one byte row (every layer's latent rows, then its
positions) and demotes, stages and promotes it bit for bit; randomized
pressure keeps ``check_invariants``; an undersized pool with the tier
gives the tokens of a pool with none; MLA plans feed the prefetch oracle
(``sel_blocks``) with the reference's counts.  The reference's own host
tier tests are red on this jax (``jax.device_put`` rejects its memory
kind), so the tier is held to its invariants and to a no-tier pool.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.model import build_model as ref_build
from repro.serving import cache as ref_cache
from repro.serving import pool as ref_pool
from repro.serving import request as ref_rq
from repro.serving.engine import Engine as RefEngine
from repro.serving.request import make_requests as ref_requests
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config as port_config
from repro_torch.serving import pool as port_pool
from repro_torch.serving import request as rq
from repro_torch.serving.cache import LatentCache
from repro_torch.serving.engine import Engine
from repro_torch.serving.pool import (PagedKVCache, _slab_leaves,
                                      _slab_nbytes, blocks_for_request)
from repro_torch.serving.request import make_requests
from repro_torch.serving.scheduler import Scheduler
from repro_torch.training.checkpoint import from_flat

torch.set_num_threads(2)

BS = 16
ARCH = "deepseek-v3-671b"
VARIANTS = {
    "full": ("full", {}),
    "quoka_staged": ("quoka", {}),
    "quoka_g16": ("quoka", {"granularity": 16}),
}


def _pair(qover=None):
    """(reference model, its params, the port's model with those weights)
    for deepseek-v3 smoke (one ``mla`` and one ``mla_moe`` layer)."""
    qover = qover or {}
    rc = ref_config(ARCH).smoke()
    rc = dataclasses.replace(rc, quoka=dataclasses.replace(rc.quoka, **qover))
    pc = port_config(ARCH).smoke()
    pc = dataclasses.replace(pc, quoka=dataclasses.replace(pc.quoka, **qover))
    rm = ref_build(rc)
    params = rm.init(jax.random.PRNGKey(0))
    return rm, params, from_flat(_flatten(params), pc, "cpu")


@pytest.fixture(scope="module")
def deepseek():
    return _pair()


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, (n,)).astype(np.int32) for n in lens]


def _same_tokens(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))


def _layers(data):
    return [c for st in data for c in st]


# ---------------------------------------------------------------------------
# device helpers on latent blocks
# ---------------------------------------------------------------------------

def _filled_pools(models, n_blocks, seed):
    """Both pools holding the same random latent / rope / pos numbers (the
    reference's per-stack leaves (1, N, bs, ...), the port's one buffer
    per layer)."""
    rm, pm = models
    rpool = ref_pool.PagedKVCache(rm, num_blocks=n_blocks, block_size=BS)
    ppool = PagedKVCache(pm, num_blocks=n_blocks, block_size=BS)
    rng = np.random.default_rng(seed)
    stacks = []
    for st, pst in zip(rpool.data.stacks, ppool.data):
        blks = []
        for blk, c in zip(st, pst):
            lat = blk.latent
            ckv = rng.standard_normal(lat.ckv.shape).astype(np.float32)
            kr = rng.standard_normal(lat.krope.shape).astype(np.float32)
            pos = rng.integers(-1, 200, lat.pos.shape).astype(np.int32)
            blks.append(blk._replace(latent=ref_cache.LatentCache(
                ckv=jnp.asarray(ckv), krope=jnp.asarray(kr),
                pos=jnp.asarray(pos))))
            c.latent.copy_(torch.as_tensor(np.concatenate([ckv[0], kr[0]],
                                                          -1)))
            c.pos.copy_(torch.as_tensor(pos[0]))
        stacks.append(tuple(blks))
    rpool.data = rpool.data._replace(stacks=tuple(stacks))
    return rpool, ppool


def _assert_latent_equal(port_data, ref_data):
    for c, blk in zip(_layers(port_data),
                      [b for st in ref_data.stacks for b in st]):
        assert isinstance(c, LatentCache)
        assert c.rank == blk.latent.ckv.shape[-1]
        np.testing.assert_array_equal(c.ckv.numpy(),
                                      np.asarray(blk.latent.ckv[0]))
        np.testing.assert_array_equal(c.krope.numpy(),
                                      np.asarray(blk.latent.krope[0]))
        np.testing.assert_array_equal(c.pos.numpy(),
                                      np.asarray(blk.latent.pos[0]))


def test_pool_store_is_the_models_latent_cache(deepseek):
    _, _, pm = deepseek
    pool = PagedKVCache(pm, num_blocks=5, block_size=BS)
    m = pm.cfg.mla
    for c in _layers(pool.data):
        assert isinstance(c, LatentCache) and c.rank == m.kv_lora_rank
        assert c.latent.shape == (5, BS, m.kv_lora_rank + m.qk_rope_dim)
        assert c.pos.shape == (5, BS) and bool((c.pos == -1).all())
    assert _slab_leaves(pool.data) == [c.latent for c in _layers(pool.data)] \
        + [c.pos for c in _layers(pool.data)]
    assert _slab_nbytes(pool.data) == len(_layers(pool.data)) * BS * (
        (m.kv_lora_rank + m.qk_rope_dim) * 4 + 4)


def test_latent_gather_scatter_and_cow_match_reference(deepseek):
    """Gather reads -1 table entries as pos -1 and a zero latent and keeps
    each layer's ``LatentCache`` (with its rank); scatter writes only
    touched, mapped blocks; the COW copy invalidates the donor's private
    slots; each moves the reference's numbers."""
    rm, _, pm = deepseek
    rpool, ppool = _filled_pools((rm, pm), 9, seed=1)
    table = np.array([[4, 0, -1, 7], [2, 8, 5, -1], [-1, -1, -1, -1]],
                     np.int32)
    pg = port_pool.gather(ppool.data, table, 9, BS)
    rg = ref_pool.gather(rpool.data, jnp.asarray(table), 9, BS)
    _assert_latent_equal(pg, rg)
    assert bool((pg[0][0].latent[2] == 0).all())
    slot = np.array([20, 33, 0], np.int32)
    n_tok = np.array([16, 1, 0], np.int32)
    touched = port_pool.touched_blocks(slot, n_tok, 4, BS)
    rng = np.random.default_rng(2)
    stacks = []
    for pst, rst in zip(pg, rg.stacks):
        blks = []
        for c, blk in zip(pst, rst):                # the step's writes
            c.latent.copy_(torch.as_tensor(
                rng.standard_normal(c.latent.shape)))
            c.pos.copy_(torch.as_tensor(rng.integers(0, 99, c.pos.shape)))
            r = c.rank
            blks.append(blk._replace(latent=ref_cache.LatentCache(
                ckv=jnp.asarray(c.latent[None, ..., :r].numpy()),
                krope=jnp.asarray(c.latent[None, ..., r:].numpy()),
                pos=jnp.asarray(c.pos[None].numpy()))))
        stacks.append(tuple(blks))
    rg = rg._replace(stacks=tuple(stacks))
    port_pool.scatter(ppool.data, pg, table, touched, 9, BS)
    rdata = ref_pool.scatter(rpool.data, rg, jnp.asarray(table),
                             jnp.asarray(touched), 9, BS)
    _assert_latent_equal(ppool.data, rdata)
    port_pool._cow_block(ppool.data, 1, 3, 5)
    rdata = ref_pool._cow_block(rdata, jnp.int32(1), jnp.int32(3),
                                jnp.int32(5))
    _assert_latent_equal(ppool.data, rdata)
    ids = np.array([[3, 0, -1], [2, 2, 1]], np.int32)
    _assert_latent_equal(
        port_pool.gather_blocks(ppool.data, table[:2], ids, 9, BS),
        ref_pool.gather_blocks(rdata, jnp.asarray(table[:2]),
                               jnp.asarray(ids), 9, BS))


def test_freed_latent_blocks_are_stamped(deepseek):
    _, _, pm = deepseek
    pool = PagedKVCache(pm, num_blocks=4, block_size=BS)
    pool.alloc(0, 2)
    blocks = pool.table(0)
    for c in _layers(pool.data):
        c.pos[blocks] = 5
    pool.free(0)
    for c in _layers(pool.data):
        assert bool((c.pos[blocks] == -1).all())
    pool.check_invariants()


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_serve_matches_reference_and_generate(variant):
    """A ragged tail (24) and interleaved prefill/decode steps: greedy
    tokens, step counts and occupancy equal the reference's serve, and
    each whole-chunk request its own ``generate``."""
    method, qover = VARIANTS[variant]
    rm, params, pm = _pair(qover)
    prompts = _prompts(3, (16, 48, 32, 24), rm.cfg.vocab)
    kw = dict(block_size=BS, max_decode_batch=4, max_prefill_tokens=32)
    want = RefEngine(rm, params, method=method).serve(
        ref_requests(prompts, 6), **kw)
    eng = Engine(pm, method=method, device="cpu")
    got = eng.serve(make_requests(prompts, 6), **kw)
    _same_tokens(got.tokens, want.tokens)
    assert (got.steps, got.prefill_steps, got.decode_steps) == \
        (want.steps, want.prefill_steps, want.decode_steps)
    assert got.occupancy == pytest.approx(want.occupancy)
    for i, pr in enumerate(prompts):
        if variant == "quoka_g16" and len(pr) % BS:
            continue
        one = eng.generate(eng.pad_prompt(pr[None]), 6).tokens[0]
        np.testing.assert_array_equal(got.tokens[i], one)


@pytest.mark.parametrize("method", ["full", "quoka"])
def test_prefix_hit_matches_reference(deepseek, method):
    """Pass 2 over a warm pool admits every request through a prefix hit
    on latent blocks, with the reference's hit lengths, stats and tokens."""
    rm, params, pm = deepseek
    sys_tok = _prompts(3, (48,), rm.cfg.vocab)[0]
    prompts = [np.concatenate([sys_tok, s])
               for s in _prompts(4, (16, 16, 16), rm.cfg.vocab)]
    reng = RefEngine(rm, params, method=method)
    eng = Engine(pm, method=method, device="cpu")
    rstate = reng.make_serve_state(ref_requests(prompts, 6), block_size=BS,
                                   max_decode_batch=4)
    state = eng.make_serve_state(make_requests(prompts, 6), block_size=BS,
                                 max_decode_batch=4)
    for _ in ("cold", "hot"):
        want = reng.serve(ref_requests(prompts, 6), state=rstate)
        got = eng.serve(make_requests(prompts, 6), state=state)
        _same_tokens(got.tokens, want.tokens)
        assert got.cached_len == want.cached_len
        assert got.prefix == pytest.approx(dict(want.prefix))
    assert all(v > 0 for v in got.cached_len.values())
    state.pool.check_invariants()


def test_cow_shared_tail_matches_reference(deepseek):
    """Turn 2 extends turn 1's ragged prompt: the shared prefix ends inside
    a latent block and is served by a copy-on-write clone (dense attention
    hits at token granularity), with the reference's tokens and
    ``generate``'s."""
    rm, params, pm = deepseek
    base = _prompts(5, (40,), rm.cfg.vocab)[0]
    turn2 = np.concatenate([base, _prompts(6, (13,), rm.cfg.vocab)[0]])
    reng = RefEngine(rm, params, method="full")
    eng = Engine(pm, method="full", device="cpu")
    rstate = reng.make_serve_state(ref_requests([base, turn2], 4),
                                   block_size=BS, max_decode_batch=2)
    state = eng.make_serve_state(make_requests([base, turn2], 4),
                                 block_size=BS, max_decode_batch=2)
    _same_tokens(eng.serve(make_requests([base], 4), state=state).tokens,
                 reng.serve(ref_requests([base], 4), state=rstate).tokens)
    got = eng.serve([rq.Request(rid=9, tokens=turn2, max_new=4)],
                    state=state)
    want = reng.serve([ref_rq.Request(rid=9, tokens=turn2, max_new=4)],
                      state=rstate)
    assert got.cached_len[9] == want.cached_len[9] == 40
    assert eng.stats["cow_copies"] == 1
    _same_tokens(got.tokens, want.tokens)
    one = eng.generate(eng.pad_prompt(turn2[None]), 4).tokens[0]
    np.testing.assert_array_equal(got.tokens[9], one)


# ---------------------------------------------------------------------------
# the host tier over latent slabs
# ---------------------------------------------------------------------------

def _fill(pool, blocks, seed=5):
    for c in _layers(pool.data):
        for j, b in enumerate(blocks):
            c.latent[b] = (seed + j) * 0.25
            c.latent[b, :, -1] = -(seed + j)
            c.pos[b] = seed + j


def _snap(pool, blocks):
    ids = torch.as_tensor(blocks)
    return [leaf.index_select(0, ids).clone() for c in _layers(pool.data)
            for leaf in (c.latent, c.pos)]


def test_latent_demote_stage_promote_roundtrip(deepseek):
    """Pressure demotes a registered latent prefix into host slabs (one
    packed byte row each, bit for bit the device block's leaves); a staged
    and an unstaged promotion write the latent rows and positions back
    unchanged, and the hash is on the device tier alone again."""
    _, _, pm = deepseek
    pool = PagedKVCache(pm, num_blocks=3, block_size=BS, host_tier_blocks=4)
    assert pool.host.store.shape == (4, _slab_nbytes(pool.data))
    toks = np.arange(2 * BS, dtype=np.int32) + 3
    pool.alloc(0, 2)
    donor = list(pool.table(0))
    _fill(pool, donor)
    pool.register_prefix(0, toks)
    want = _snap(pool, donor)
    packed = [torch.cat([leaf[b].reshape(-1).view(torch.uint8)
                         for leaf in _slab_leaves(pool.data)])
              for b in donor]
    pool.free(0)
    pool.alloc(1, 3)                             # pressure: demotes both
    assert pool.demoted == 2
    fulls, tail = pool.match_prefix(toks)
    assert all(isinstance(b, tuple) for b in fulls) and tail is None
    for e, row in zip(fulls, packed):
        assert torch.equal(pool.host.row(e[1]), row)
    pool.check_invariants()
    pool.free(1)
    assert pool.stage(fulls[0][1]) == 1
    table = pool.alloc_prefix(2, 3, shared=fulls)
    assert pool.promoted == 2 and pool.staged_used == 1
    for w, g in zip(want, _snap(pool, table[:2])):
        assert torch.equal(w, g)
    assert pool.match_prefix(toks)[0] == table[:2]
    pool.check_invariants()


def test_latent_host_cow_tail(deepseek):
    """A host COW tail source over latent blocks is copied, not consumed:
    the clone keeps the shared slots' latent and positions and invalidates
    the rest; the host copy stays matchable."""
    _, _, pm = deepseek
    pool = PagedKVCache(pm, num_blocks=3, block_size=BS, host_tier_blocks=4)
    toks = np.arange(BS + 5, dtype=np.int32) + 3
    pool.alloc(0, 2)
    donor = list(pool.table(0))
    _fill(pool, donor)
    pool.register_prefix(0, toks)            # one full block + a 5-slot tail
    want = _snap(pool, donor)
    pool.free(0)
    pool.alloc(1, 3)                          # demotes the full and the tail
    pool.free(1)
    fulls, tail = pool.match_prefix(toks)
    assert isinstance(fulls[0], tuple) and isinstance(tail[0], tuple)
    table = pool.alloc_prefix(2, 2, shared=fulls, cow=(tail[0], 3))
    got = _snap(pool, table)
    for w, g in zip(want[0::2], got[0::2]):            # latent rows
        assert torch.equal(w, g)
    for w, g in zip(want[1::2], got[1::2]):            # positions
        assert torch.equal(g[0], w[0])
        assert torch.equal(g[1, :3], w[1, :3]) and bool((g[1, 3:] == -1).all())
    assert isinstance(pool.match_prefix(toks)[1][0], tuple)
    pool.check_invariants()


def test_latent_host_tier_randomized_invariants(deepseek):
    """200 randomized admit/free cycles over a tiny latent pool and a
    tinier host tier: the invariants hold while demotion, promotion
    (staged and not) and host eviction all happen."""
    _, _, pm = deepseek
    pool = PagedKVCache(pm, num_blocks=8, block_size=BS, host_tier_blocks=3)
    sched = Scheduler(pool, chunk_size=BS, max_prefill_tokens=BS,
                      max_decode_batch=8, prefix_cache=True, prefix_align=1)
    rng = np.random.default_rng(7)
    fams = [rng.integers(3, 100, (3 * BS,)).astype(np.int32)
            for _ in range(3)]
    held, rid = {}, 0
    for _ in range(200):
        if held and (rng.random() < 0.5 or not pool.can_alloc(4)):
            victim = int(rng.choice(list(held)))
            pool.free(victim)
            del held[victim]
        else:
            fam = fams[int(rng.integers(len(fams)))]
            plen = int(rng.integers(BS, len(fam)))
            toks = fam[:plen].copy()
            r = rq.Request(rid=rid, tokens=toks, max_new=1)
            cached, shared, cow = sched._match(r)
            dev_shared = [b for b in shared if not isinstance(b, tuple)]
            protect = dev_shared + \
                ([cow[0]] if cow and not isinstance(cow[0], tuple) else [])
            n = blocks_for_request(plen, 1, BS, BS, cached_len=cached)
            if pool.can_alloc(n - len(dev_shared), exclude=protect):
                if rng.random() < 0.5:
                    for e in shared:
                        if isinstance(e, tuple):
                            pool.stage(e[1])
                pool.alloc_prefix(rid, n, shared, cow)
                pool.register_prefix(rid, toks)
                held[rid] = True
                rid += 1
        pool.check_invariants()
    assert pool.demoted > 0 and pool.promoted > 0
    assert pool.host_evictions > 0 and pool.staged_used > 0
    for r_ in list(held):
        pool.free(r_)
    pool.check_invariants()


@pytest.mark.parametrize("method", ["full", "quoka"])
def test_undersized_pool_with_host_tier_parity(deepseek, method):
    """A latent pool below the trace's working set plus the tier gives the
    greedy tokens of the reference's big-pool serve (no tier) and of the
    port's ``generate``, cold and on the hit pass; the tier is exercised
    (demotions, then promotions, some from the prefetch's staging)."""
    rm, params, pm = deepseek
    prompts = _prompts(21, (2 * BS,) * 4, pm.cfg.vocab)
    max_new = 4
    reng = RefEngine(rm, params, method=method)
    want = reng.serve(ref_requests(prompts, max_new), block_size=BS,
                      max_decode_batch=1)
    eng = Engine(pm, method=method, device="cpu")
    need = blocks_for_request(2 * BS, max_new, BS, BS)
    state = eng.make_serve_state(make_requests(prompts, max_new),
                                 block_size=BS, num_blocks=need + 1,
                                 max_decode_batch=1,
                                 host_tier_blocks=4 * need)
    cold = eng.serve(make_requests(prompts, max_new), state=state)
    assert eng.stats["demoted"] > 0
    _same_tokens(cold.tokens, want.tokens)
    hot = eng.serve(make_requests(prompts, max_new), state=state)
    assert eng.stats["promoted"] > 0 and eng.stats["cache_hits"] > 0
    _same_tokens(hot.tokens, want.tokens)
    for i, pr in enumerate(prompts):
        np.testing.assert_array_equal(
            hot.tokens[i], eng.generate({"tokens": pr[None]},
                                        max_new).tokens[0])
    state.pool.check_invariants()


@pytest.mark.parametrize("g", [1, 16])
def test_mla_sel_blocks_output_matches_reference(g):
    """MLA plans feed the prefetch oracle: ``prefill_chunk`` /
    ``decode_step`` with ``sel_blocks`` return the per-block selection
    counts summed over layers, the reference's on the same weights."""
    qover = {"granularity": g} if g > 1 else {}
    rm, params, pm = _pair(qover)
    chunk, cap, bs = 16, 96, 16
    toks = np.random.default_rng(4).integers(
        3, pm.cfg.vocab, (2, 4 * chunk)).astype(np.int32)
    rcache, pcache = rm.init_cache(2, cap), pm.init_cache(2, cap)
    for c0 in range(0, 4 * chunk, chunk):
        ch = toks[:, c0:c0 + chunk]
        rres = rm.prefill_chunk(params, {"tokens": jnp.asarray(ch)},
                                jnp.asarray(c0), rcache, "quoka",
                                backend="xla", sel_blocks=(bs, cap // bs))
        rcache = rres[1]
        pres = pm.prefill_chunk({"tokens": ch}, c0, pcache, "quoka",
                                sel_blocks=(bs, cap // bs))
        np.testing.assert_array_equal(pres[2].numpy(), np.asarray(rres[2]))
    tok = np.asarray([5, 7], np.int32)
    rres = rm.decode_step(params, jnp.asarray(tok), jnp.asarray(4 * chunk),
                          rcache, "quoka", backend="xla",
                          sel_blocks=(bs, cap // bs))
    pres = pm.decode_step(torch.as_tensor(tok).long(), 4 * chunk, pcache,
                          "quoka", sel_blocks=(bs, cap // bs))
    assert int(pres[2].sum()) > 0
    np.testing.assert_array_equal(pres[2].numpy(), np.asarray(rres[2]))
