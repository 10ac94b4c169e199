"""The port's host-memory tier behind the paged KV pool, on the CPU.

The reference's own tests of the tier (``test_host_tier.py``) and of
suspend/resume with the tier on are red on this jax (``jax.device_put``
rejects its pinned-host memory kind), so its invariants are checked here
inside the port: a demote -> match -> promote round trip is bit-identical;
slot maps, LRU order, hash indices and single residency across the tiers
hold under randomized pressure; an undersized pool with the tier gives the
greedy tokens of the reference's big-pool ``serve`` (no tier) and of its
``generate``, on the cold pass and the hit pass; the prefetch stages
between a step's dispatch and its one sync; suspend/resume with the tier
on is token-identical.  The prefetch oracle (``pool_block_counts`` and the
model's ``sel_blocks`` output) equals the reference's on the same plans
and weights.  On a CPU pool the tier's rows are plain host tensors (pinned
memory needs a card; ``test_torch_cuda.py`` covers that path).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import plan as ref_plan
from repro.models.model import build_model as ref_build
from repro.serving.engine import Engine as RefEngine
from repro.serving.request import make_requests as ref_requests
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config as port_config
from repro_torch.core import plan as port_plan
from repro_torch.serving import request as rq
from repro_torch.serving.engine import Engine
from repro_torch.serving.pool import (PagedKVCache, _slab_nbytes,
                                      blocks_for_request)
from repro_torch.serving.request import make_requests
from repro_torch.serving.scheduler import Scheduler
from repro_torch.training.checkpoint import from_flat

torch.set_num_threads(2)

BS = 16


def _pair(qover=None):
    """(reference model, its params, the port's model with those weights)
    for granite-3-2b smoke, the model of the reference's tier tests."""
    qover = qover or {}
    rc = ref_config("granite-3-2b").smoke()
    rc = dataclasses.replace(rc, quoka=dataclasses.replace(rc.quoka, **qover))
    pc = port_config("granite-3-2b").smoke()
    pc = dataclasses.replace(pc, quoka=dataclasses.replace(pc.quoka, **qover))
    rm = ref_build(rc)
    params = rm.init(jax.random.PRNGKey(0))
    return rm, params, from_flat(_flatten(params), pc, "cpu")


@pytest.fixture(scope="module")
def granite():
    return _pair()


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, (n,)).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# pool level
# ---------------------------------------------------------------------------

def _fill(pool, blocks, seed=5):
    """Recognisable content per block in every leaf of every layer."""
    for st in pool.data:
        for kv in st:
            for j, b in enumerate(blocks):
                kv.k[b] = (seed + j) * 0.25
                kv.v[b] = -(seed + j) * 0.5
                kv.pos[b] = seed + j


def _snap(pool, blocks):
    ids = torch.as_tensor(blocks)
    return [leaf.index_select(0, ids).clone() for st in pool.data
            for kv in st for leaf in kv]


def test_demote_match_promote_roundtrip(granite):
    """Pressure moves a registered prefix to the host tier (matchable as
    ("host", slot) entries); ``alloc_prefix`` promotes it into fresh
    device blocks carrying bit-identical K, V and positions, and the hash
    is back on the device tier alone."""
    _, _, pm = granite
    pool = PagedKVCache(pm, num_blocks=3, block_size=BS, host_tier_blocks=4)
    assert not pool.host.store.is_pinned()
    assert pool.host.store.shape == (4, _slab_nbytes(pool.data))
    toks = np.arange(2 * BS, dtype=np.int32) + 3
    pool.alloc(0, 2)
    donor = list(pool.table(0))
    _fill(pool, donor)
    pool.register_prefix(0, toks)
    want = _snap(pool, donor)
    pool.free(0)                                 # both blocks on the LRU
    pool.alloc(1, 3)                             # pressure: demotes both
    assert pool.demoted == 2
    fulls, tail = pool.match_prefix(toks)
    assert all(isinstance(b, tuple) for b in fulls)
    assert len(fulls) == 2 and tail is None
    pool.check_invariants()
    pool.free(1)
    table = pool.alloc_prefix(2, 3, shared=fulls)
    assert pool.promoted == 2 and pool.staged_used == 0
    for w, g in zip(want, _snap(pool, table[:2])):
        assert torch.equal(w, g)
    fulls2, _ = pool.match_prefix(toks)
    assert fulls2 == table[:2]
    pool.check_invariants()


def test_staged_promotion_and_host_cow_tail(granite):
    """A staged slot is consumed by its promotion (``staged_used``); a host
    COW tail source is copied, not consumed: the clone keeps the shared
    slots and invalidates the rest, and the host copy stays matchable."""
    _, _, pm = granite
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
    assert tail[1] == 5
    assert pool.stage(fulls[0][1]) == 1 and pool.stage(fulls[0][1]) == 0
    table = pool.alloc_prefix(2, 2, shared=fulls, cow=(tail[0], 3))
    assert pool.promoted == 1 and pool.staged_used == 1
    got = _snap(pool, table)
    for w, g in zip(want, got):
        assert torch.equal(w[0], g[0])                 # promoted block
    for w, g in zip(want[2::3], got[2::3]):            # the COW clone's pos
        assert torch.equal(g[1, :3], w[1, :3])
        assert bool((g[1, 3:] == -1).all())
    _, tail2 = pool.match_prefix(toks)
    assert tail2 is not None and isinstance(tail2[0], tuple)
    pool.check_invariants()


def test_host_tier_randomized_invariants(granite):
    """200 randomized admit/free cycles over a tiny device pool and a
    tinier host tier: slot maps, LRU order, hash indices and single
    residency across the tiers stay consistent while demotion, promotion
    and host eviction all happen."""
    _, _, pm = granite
    pool = PagedKVCache(pm, num_blocks=8, block_size=BS, host_tier_blocks=3)
    sched = Scheduler(pool, chunk_size=BS, max_prefill_tokens=BS,
                      max_decode_batch=8, prefix_cache=True, prefix_align=1)
    rng = np.random.default_rng(1)
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
                if rng.random() < 0.5:         # some promotions are staged
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


# ---------------------------------------------------------------------------
# the prefetch oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 16])
def test_pool_block_counts_match_reference(g):
    """Selected entries per logical pool block, padding dropped, equal the
    reference's on the same plans (token plans per KV head at g = 1, block
    plans at g = 16)."""
    rng = np.random.default_rng(g)
    cfg_r = dataclasses.replace(ref_config("granite-3-2b").quoka,
                                granularity=g)
    cfg_p = dataclasses.replace(port_config("granite-3-2b").quoka,
                                granularity=g)
    b, n_kv, T, bs = 3, 2, 256, 32
    if g == 1:
        idx = rng.integers(-1, T, (b, n_kv, 40)).astype(np.int32)
    else:
        idx = rng.integers(-1, T // g, (b, 9)).astype(np.int32)
    idx[0, ..., :3] = -1
    want = ref_plan.pool_block_counts(ref_plan.SelectionPlan(
        idx=jnp.asarray(idx)), cfg_r, bs, T // bs)
    got = port_plan.pool_block_counts(port_plan.SelectionPlan(
        idx=torch.as_tensor(idx).long()), cfg_p, bs, T // bs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("g", [1, 16])
def test_sel_blocks_output_matches_reference(g):
    """``prefill_chunk`` / ``decode_step`` with ``sel_blocks`` return the
    counts summed over layers, equal to the reference's on the same weights
    and cache (a view past budget + chunk, so every layer selects)."""
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


# ---------------------------------------------------------------------------
# end to end: the tier is invisible to outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["full", "quoka"])
def test_undersized_pool_with_host_tier_parity(granite, method):
    """A pool below the trace's working set plus the tier gives the greedy
    tokens of the reference's big-pool serve (no tier) and of its
    ``generate``, on the cold pass and the hit pass; the tier is exercised
    (demotions on the cold pass, promotions on the hit pass) and hits stay
    on the B_CP grid for ``quoka``."""
    rm, params, pm = granite
    prompts = _prompts(21, (2 * BS,) * 4, pm.cfg.vocab)
    max_new = 4
    ref_eng = RefEngine(rm, params, method=method)
    refs = [ref_eng.generate(ref_eng.pad_prompt(pr[None]),
                             max_new).tokens[0] for pr in prompts]
    big = ref_eng.make_serve_state(ref_requests(prompts, max_new),
                                   block_size=BS, max_decode_batch=1)
    big_res = ref_eng.serve(ref_requests(prompts, max_new), state=big)
    eng = Engine(pm, method=method, device="cpu")
    need = blocks_for_request(2 * BS, max_new, BS, BS)
    state = eng.make_serve_state(make_requests(prompts, max_new),
                                 block_size=BS, num_blocks=need + 1,
                                 max_decode_batch=1,
                                 host_tier_blocks=4 * need)
    cold = eng.serve(make_requests(prompts, max_new), state=state)
    assert eng.stats["demoted"] > 0
    for i, want in enumerate(refs):
        np.testing.assert_array_equal(np.asarray(big_res.tokens[i]), want)
        np.testing.assert_array_equal(cold.tokens[i], want)
    hot = eng.serve(make_requests(prompts, max_new), state=state)
    assert eng.stats["promoted"] > 0 and eng.stats["cache_hits"] > 0
    assert any(v > 0 for v in hot.cached_len.values())
    if method != "full":
        assert all(v % pm.cfg.quoka.chunk_size == 0
                   for v in hot.cached_len.values())
    for i, want in enumerate(refs):
        np.testing.assert_array_equal(hot.tokens[i], want)
    state.pool.check_invariants()


def test_prefetch_stages_between_dispatch_and_sync(granite, monkeypatch):
    """x queues behind y (one decode slot): x's host blocks are staged
    while y's steps run — every stage falls inside a step function's
    dispatch, before that step's one host copy — and at least one
    promotion consumes a staged slab.  Tokens equal the reference's."""
    rm, params, pm = granite
    eng = Engine(pm, method="quoka", device="cpu")
    x, y = _prompts(23, (2 * BS, 2 * BS), pm.cfg.vocab)
    need = blocks_for_request(2 * BS, 4, BS, BS)
    state = eng.make_serve_state(make_requests([x], 4), block_size=BS,
                                 num_blocks=need + 1, max_decode_batch=1,
                                 host_tier_blocks=4 * need, prefetch_depth=4)
    eng.serve(make_requests([x], 4), state=state)     # register x
    eng.serve(make_requests([y], 4), state=state)     # pressure demotes x
    assert eng.stats["demoted"] > 0
    log = []
    fns = state.fns

    def logged(i):
        def fn(*a, **kw):
            log.append(("dispatch", i))
            return fns[i](*a, **kw)
        return fn

    state.fns = (logged(0), logged(1))
    real_stage, real_fetch = state.pool.stage, eng._fetch

    def stage(*slots):
        log.append(("stage", slots))
        return real_stage(*slots)

    def fetch(out):
        log.append(("sync", None))
        return real_fetch(out)

    monkeypatch.setattr(state.pool, "stage", stage)
    monkeypatch.setattr(eng, "_fetch", fetch)
    res = eng.serve(make_requests([y, x], 4), state=state)
    assert eng.stats["staged_used"] >= 1 and eng.stats["promoted"] >= 1
    stages = [i for i, (k, _) in enumerate(log) if k == "stage"]
    assert stages, "prefetch never staged a host block"
    for i in stages:
        prev = [k for k, _ in log[:i] if k != "stage"]
        nxt = [k for k, _ in log[i + 1:] if k != "stage"]
        assert prev[-1] == "dispatch" and nxt[0] == "sync", log
    assert log.count(("sync", None)) == sum(k == "dispatch" for k, _ in log)
    ref_eng = RefEngine(rm, params, method="quoka")
    for i, pr in enumerate((y, x)):
        want = ref_eng.generate(ref_eng.pad_prompt(pr[None]), 4).tokens[0]
        np.testing.assert_array_equal(res.tokens[i], want)
    state.pool.check_invariants()


@pytest.mark.parametrize("method", ["full", "quoka"])
def test_suspend_resume_with_host_tier_token_identity(granite, method):
    """Preempting a decoding request demotes the blocks it owned alone to
    the host tier; resuming promotes them, and the tokens equal an
    uninterrupted run's and the reference's (no tier)."""
    rm, params, pm = granite
    prompt = _prompts(23, (40,), pm.cfg.vocab)[0]
    kw = dict(block_size=BS, max_decode_batch=2, policy="slo")
    want = RefEngine(rm, params, method=method).serve(
        ref_requests([prompt], 8), **kw)
    eng = Engine(pm, method=method, device="cpu")
    state = eng.make_serve_state(make_requests([prompt], 8),
                                 host_tier_blocks=32, **kw)
    forced = []
    sched = state.sched
    for r in make_requests([prompt], 8):
        sched.add(r)
    steps = 0
    while sched.pending():
        r = sched.decoding[0] if sched.decoding else None
        if not forced and r is not None and len(r.out) >= 3:
            sched.suspend(r, state.now)
            forced.append(r)
        eng.step(state)
        steps += 1
        assert steps < 200, "drive did not drain"
    assert forced and forced[0].preemptions == 1 and sched.resumes == 1
    assert state.pool.demoted > 0 and state.pool.promoted > 0
    state.pool.check_invariants()
    np.testing.assert_array_equal(np.asarray(sched.done[0].out, np.int32),
                                  np.asarray(want.tokens[0]))
