"""The port's paged KV pool and scheduler bookkeeping against the JAX
reference's (``repro/serving/pool.py``, ``scheduler.py``).

The same alloc / free / match / COW / evict sequence, driven on both pools
at once, must leave identical block tables, free lists, LRU orders,
refcounts, registrations, hash indices and counters after every step; the
chain hashes (hence every prefix hit) must be identical; and the device
helpers (gather, scatter, stamping, COW copy, per-row ``kv_write``) must
move the same numbers.  Mirrors the invariants of ``test_prefix_cache.py``
and ``test_scheduler.py`` (pool alloc/free, stamping, hash chain,
pin-before-alloc).
"""
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
from repro.serving.scheduler import Scheduler as RefScheduler
from repro_torch.configs import get_config as port_config
from repro_torch.models.model import build_model
from repro_torch.serving import cache as port_cache
from repro_torch.serving import pool as port_pool
from repro_torch.serving import request as port_rq
from repro_torch.serving.scheduler import Scheduler

torch.set_num_threads(2)

BS = 16


@pytest.fixture(scope="module")
def models():
    return (ref_build(ref_config("granite-3-2b").smoke()),
            build_model(port_config("granite-3-2b").smoke(), device="cpu"))


def _state(pool):
    """Every piece of host bookkeeping the two pools must agree on."""
    return dict(tables=dict(pool._tables), free=list(pool._free),
                lru=list(pool._lru), ref=dict(pool._ref),
                reg=dict(pool._reg), full=dict(pool._full),
                tail=dict(pool._tail), evictions=pool.evictions,
                cow_copies=pool.cow_copies)


def _pos_of(pool_port):
    return [kv.pos.numpy().copy() for st in pool_port.data for kv in st]


def _pos_of_ref(pool_ref):
    return list(np.asarray(pool_ref.data.stacks[0][0].kv.pos))


def test_chain_hashes_and_block_bounds_match_reference():
    rng = np.random.default_rng(0)
    for n in (0, 15, 16, 17, 64, 130):
        toks = rng.integers(3, 1000, (n,)).astype(np.int32)
        for bs in (16, 128):
            assert port_pool._chain_hashes(toks, bs) == \
                ref_pool._chain_hashes(toks, bs)
    for plen in (1, 17, 40, 128, 3000):
        for max_new in (1, 8, 33):
            for chunk, bs in ((16, 16), (32, 8), (128, 128)):
                for cached in (0, plen // 2, max(0, plen - 1)):
                    args = (plen, max_new, chunk, bs)
                    assert port_pool.blocks_for_request(
                        *args, cached_len=cached) == \
                        ref_pool.blocks_for_request(*args, cached_len=cached)
                    assert port_pool.blocks_for_resume(
                        plen + max_new - 1, *args, cached) == \
                        ref_pool.blocks_for_resume(plen + max_new - 1, *args,
                                                   cached)
                for align in (0, 1, chunk):
                    for pre in (False, True):
                        assert port_pool.max_blocks_bound(
                            *args, align=align, preempt=pre) == \
                            ref_pool.max_blocks_bound(*args, align=align,
                                                      preempt=pre)


def test_pool_alloc_free_invariants(models):
    """Random admit/evict cycles give the reference's tables and free list
    step for step; misuse raises as in the reference."""
    rm, pm = models
    rpool = ref_pool.PagedKVCache(rm, num_blocks=12, block_size=BS)
    ppool = port_pool.PagedKVCache(pm, num_blocks=12, block_size=BS)
    rng = np.random.default_rng(0)
    held = {}
    for step in range(200):
        if held and (rng.random() < 0.5 or ppool.num_free < 3):
            rid = int(rng.choice(list(held)))
            assert ppool.free(rid) == rpool.free(rid)
            del held[rid]
        else:
            rid, n = step, int(rng.integers(1, 4))
            assert ppool.can_alloc(n) == rpool.can_alloc(n)
            if ppool.can_alloc(n):
                held[rid] = ppool.alloc(rid, n)
                assert held[rid] == rpool.alloc(rid, n)
        ppool.check_invariants()
        assert _state(ppool) == _state(rpool)
    for rid in list(held):
        ppool.free(rid)
    ppool.check_invariants()
    assert ppool.num_free == 12
    ppool.alloc(0, 2)
    with pytest.raises(RuntimeError):
        ppool.alloc(0, 1)                    # double-allocate a request
    with pytest.raises(RuntimeError):
        ppool.alloc(1, 11)                   # beyond capacity
    ppool.free(0)
    with pytest.raises(KeyError):
        ppool.free(0)                        # double free


def test_prefix_cache_sequence_matches_reference(models):
    """The reference's randomized refcount/LRU sweep over heavily
    overlapping prompts (sharing, COW tails and eviction all trigger),
    driven on both packages: identical bookkeeping after every step and
    identical stamped positions on the device."""
    rm, pm = models
    rpool = ref_pool.PagedKVCache(rm, num_blocks=10, block_size=BS)
    ppool = port_pool.PagedKVCache(pm, num_blocks=10, block_size=BS)
    kw = dict(chunk_size=BS, max_prefill_tokens=BS, max_decode_batch=8,
              prefix_cache=True, prefix_align=1)
    rsched, psched = RefScheduler(rpool, **kw), Scheduler(ppool, **kw)
    rng = np.random.default_rng(0)
    fams = [rng.integers(3, 100, (3 * BS,)).astype(np.int32)
            for _ in range(2)]
    held, rid = {}, 0
    for step in range(300):
        if held and (rng.random() < 0.5 or not ppool.can_alloc(4)):
            victim = int(rng.choice(list(held)))
            assert ppool.free(victim) == rpool.free(victim)
            del held[victim]
        else:
            fam = fams[int(rng.integers(len(fams)))]
            plen = int(rng.integers(BS, len(fam)))
            toks = fam[:plen].copy()
            hit = psched._match(port_rq.Request(rid=rid, tokens=toks,
                                                max_new=1))
            assert hit == rsched._match(ref_rq.Request(rid=rid, tokens=toks,
                                                       max_new=1))
            cached, shared, cow = hit
            n = port_pool.blocks_for_request(plen, 1, BS, BS,
                                             cached_len=cached)
            protect = shared + ([cow[0]] if cow else [])
            if ppool.can_alloc(n - len(shared), exclude=protect):
                assert ppool.alloc_prefix(rid, n, shared, cow) == \
                    rpool.alloc_prefix(rid, n, shared, cow)
                ppool.register_prefix(rid, toks)
                rpool.register_prefix(rid, toks)
                held[rid] = True
                rid += 1
        ppool.check_invariants()
        assert _state(ppool) == _state(rpool)
    assert ppool.cow_copies > 0 and ppool.evictions > 0
    for a, b in zip(_pos_of(ppool), _pos_of_ref(rpool)):
        np.testing.assert_array_equal(a, b)


def test_free_and_eviction_stamp_blocks(models):
    """A freed or evicted block reads pos -1 everywhere before reuse."""
    _, pm = models
    pool = port_pool.PagedKVCache(pm, num_blocks=2, block_size=BS)
    held = pool.alloc(0, 2)
    for st in pool.data:
        for kv in st:
            kv.pos[held] = 3                    # a donor's real positions
    pool.free(0)
    assert set(pool.alloc(1, 2)) == set(held)
    assert all((p[held] == -1).all() for p in _pos_of(pool))
    pool.free(1)
    toks = np.arange(BS, dtype=np.int32) + 3
    pool.alloc(2, 1)
    for st in pool.data:
        for kv in st:
            kv.pos[pool.table(2)] = 3
    pool.register_prefix(2, toks)
    pool.free(2)
    assert pool.num_evictable == 1 and len(pool.match_prefix(toks)[0]) == 1
    blocks = pool.alloc(3, 2)                   # forces the eviction
    assert pool.evictions == 1
    assert pool.match_prefix(toks) == ([], None)
    assert all((p[blocks] == -1).all() for p in _pos_of(pool))
    pool.check_invariants()


def test_shared_blocks_pinned_before_fresh_alloc(models):
    """A request's fresh allocation never evicts the prefix blocks it is
    about to share; the hash chain covers the whole prefix."""
    _, pm = models
    pool = port_pool.PagedKVCache(pm, num_blocks=3, block_size=BS)
    base = np.arange(BS, dtype=np.int32) + 3
    toks = np.concatenate([base, np.full(BS, 7, np.int32)])
    other = np.concatenate([base, np.full(BS, 9, np.int32)])
    pool.alloc(0, 2)
    pool.register_prefix(0, toks)
    assert pool.match_prefix(other)[0] == pool.table(0)[:1]
    pool.free(0)
    fulls, _ = pool.match_prefix(toks)
    table = pool.alloc_prefix(1, 3, shared=fulls)
    assert table[:2] == fulls
    assert not pool.can_alloc(2, exclude=fulls)
    pool.check_invariants()


def _filled_pools(models, n_blocks, seed):
    """Both pools holding the same random K/V/pos numbers."""
    rm, pm = models
    rpool = ref_pool.PagedKVCache(rm, num_blocks=n_blocks, block_size=BS)
    ppool = port_pool.PagedKVCache(pm, num_blocks=n_blocks, block_size=BS)
    rkv = rpool.data.stacks[0][0].kv
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(rkv.k.shape).astype(np.float32)
    v = rng.standard_normal(rkv.v.shape).astype(np.float32)
    pos = rng.integers(-1, 200, rkv.pos.shape).astype(np.int32)
    blk = rpool.data.stacks[0][0]._replace(kv=ref_cache.KVCache(
        k=jnp.asarray(k), v=jnp.asarray(v), pos=jnp.asarray(pos)))
    rpool.data = rpool.data._replace(stacks=((blk,),))
    for li, kv in enumerate(ppool.data[0]):
        kv.k.copy_(torch.as_tensor(k[li]))
        kv.v.copy_(torch.as_tensor(v[li]))
        kv.pos.copy_(torch.as_tensor(pos[li]))
    return rpool, ppool


def _assert_views_equal(port_data, ref_kv):
    for li, kv in enumerate(port_data[0]):
        np.testing.assert_array_equal(kv.k.numpy(), np.asarray(ref_kv.k[li]))
        np.testing.assert_array_equal(kv.v.numpy(), np.asarray(ref_kv.v[li]))
        np.testing.assert_array_equal(kv.pos.numpy(),
                                      np.asarray(ref_kv.pos[li]))


def test_gather_scatter_touched_match_reference(models):
    """Gather reads -1 table entries as pos -1 and zero K/V; scatter writes
    only touched, mapped blocks; both move the reference's numbers."""
    rpool, ppool = _filled_pools(models, 9, seed=1)
    table = np.array([[4, 0, -1, 7], [2, 8, 5, -1], [-1, -1, -1, -1]],
                     np.int32)
    pg = port_pool.gather(ppool.data, table, 9, BS)
    rg = ref_pool.gather(rpool.data, jnp.asarray(table), 9, BS)
    _assert_views_equal(pg, rg.stacks[0][0].kv)
    slot = np.array([20, 33, 0], np.int32)
    n_tok = np.array([16, 1, 0], np.int32)
    touched = port_pool.touched_blocks(slot, n_tok, 4, BS)
    np.testing.assert_array_equal(touched, np.asarray(
        ref_pool.touched_blocks(jnp.asarray(slot), jnp.asarray(n_tok), 4,
                                BS)))
    rng = np.random.default_rng(2)
    for kv in pg[0]:                          # the step's writes
        kv.k.copy_(torch.as_tensor(rng.standard_normal(kv.k.shape)))
        kv.pos.copy_(torch.as_tensor(rng.integers(0, 99, kv.pos.shape)))
    rkv = rg.stacks[0][0].kv
    new = ref_cache.KVCache(
        k=jnp.stack([jnp.asarray(kv.k.numpy()) for kv in pg[0]]),
        v=rkv.v, pos=jnp.stack([jnp.asarray(kv.pos.numpy())
                                for kv in pg[0]]))
    rg = rg._replace(stacks=((rg.stacks[0][0]._replace(kv=new),),))
    port_pool.scatter(ppool.data, pg, table, touched, 9, BS)
    rdata = ref_pool.scatter(rpool.data, rg, jnp.asarray(table),
                             jnp.asarray(touched), 9, BS)
    _assert_views_equal(ppool.data, rdata.stacks[0][0].kv)


def test_gather_blocks_matches_reference(models):
    """Only the selected logical blocks of each request (-1 ids and -1
    table entries read as pos -1 and zero K/V), as the reference gives."""
    rpool, ppool = _filled_pools(models, 9, seed=5)
    table = np.array([[4, 0, -1, 7], [2, 8, 5, -1]], np.int32)
    ids = np.array([[3, 0, -1], [2, 2, 1]], np.int32)
    pg = port_pool.gather_blocks(ppool.data, table, ids, 9, BS)
    rg = ref_pool.gather_blocks(rpool.data, jnp.asarray(table),
                                jnp.asarray(ids), 9, BS)
    _assert_views_equal(pg, rg.stacks[0][0].kv)


@pytest.mark.parametrize("rows", [2, None])
def test_pack_prefill_tail_charging_matches_reference(models, rows):
    """Two short tail chunks pack into one step when ``max_prefill_rows``
    allows two rows (each charges its real length), and into two steps
    under the default one-row geometry, as in the reference."""
    rm, pm = models
    prompts = [np.arange(5, dtype=np.int32) + 3,
               np.arange(6, dtype=np.int32) + 3]
    packs = []
    for mod, pool_mod, sched_cls, m in (
            (port_rq, port_pool, Scheduler, pm),
            (ref_rq, ref_pool, RefScheduler, rm)):
        sched = sched_cls(pool_mod.PagedKVCache(m, num_blocks=8,
                                                block_size=BS),
                          chunk_size=16, max_prefill_tokens=16,
                          max_decode_batch=2, max_prefill_rows=rows)
        for r in mod.make_requests(prompts, 2):
            sched.add(r)
        sched.admit()
        packs.append([(r.rid, st, vl) for r, _, st, vl in
                      sched.pack_prefill()])
    assert packs[0] == packs[1]
    assert [vl for *_, vl in packs[0]] == ([5, 6] if rows else [5])


def test_cow_copy_matches_reference(models):
    rpool, ppool = _filled_pools(models, 5, seed=3)
    port_pool._cow_block(ppool.data, 1, 3, 5)
    rdata = ref_pool._cow_block(rpool.data, jnp.int32(1), jnp.int32(3),
                                jnp.int32(5))
    _assert_views_equal(ppool.data, rdata.stacks[0][0].kv)


@pytest.mark.parametrize("start", [[0, 40, 7], [60, 3, 52], 17, 60])
def test_kv_write_per_row_matches_reference(start):
    """Scalar and per-row (b,) starts, including starts past cap - t,
    which both packages clamp like ``dynamic_update_slice``."""
    rng = np.random.default_rng(4)
    b, cap, t, n_kv, d = 3, 64, 8, 2, 4
    k0 = rng.standard_normal((b, cap, n_kv, d)).astype(np.float32)
    k_new = rng.standard_normal((b, t, n_kv, d)).astype(np.float32)
    pos0 = np.full((b, cap), -1, np.int32)
    st = np.asarray(start, np.int32)
    want = ref_cache.kv_write(
        ref_cache.KVCache(jnp.asarray(k0), jnp.asarray(k0),
                          jnp.asarray(pos0)),
        jnp.asarray(k_new), jnp.asarray(k_new), jnp.asarray(st))
    got = port_cache.kv_write(
        port_cache.KVCache(torch.as_tensor(k0), torch.as_tensor(k0),
                           torch.as_tensor(pos0)),
        torch.as_tensor(k_new), torch.as_tensor(k_new),
        torch.as_tensor(st) if st.ndim else int(st))
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
