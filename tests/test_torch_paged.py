"""The port's paged selected attention (``ops.selected_attention(table=)``)
on CPU tensors — its plain version, ``ref.selected_paged_ref`` — against
the JAX reference's paged route: the ``xla`` oracle (``_linearize_pool`` +
``_selected_xla``) and the Pallas paged kernel run with ``interpret=True``.

Geometry of ``tests/test_kernels.py::test_selected_attention_paged_block_
table``: the requests' linear views scattered into a permuted pool, spare
blocks poisoned with stale positions >= 0, and one unmapped (-1) logical
block; at granularity 16 (head-shared block plan) and 1 (per-KV-head token
plan), plus decode (t = 1) at a misaligned start.  Inputs are drawn with
numpy from a seed.  Tolerance 2e-5 in fp32: only summation order differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selected_attention as sa_mod

torch.set_num_threads(2)

TOL = 2e-5


def _paged_case(g, chunk, start, seed):
    """(q, k_pool, v_pool, pos_pool, table, idx) as numpy."""
    b, h, n_kv, d, bs, nb_logical = 2, 4, 2, 16, 16, 8
    T = nb_logical * bs
    N = nb_logical * b + 3                  # spare physical blocks
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, chunk, h, d), np.float32)
    k_lin = rng.standard_normal((b, T, n_kv, d), np.float32)
    v_lin = rng.standard_normal((b, T, n_kv, d), np.float32)
    pos_lin = np.arange(T, dtype=np.int32)[None].repeat(b, 0)
    pos_lin[:, start + chunk:] = -1         # beyond the written prefix
    perm = rng.permutation(N)
    k_pool = rng.standard_normal((N, bs, n_kv, d), np.float32)
    v_pool = rng.standard_normal((N, bs, n_kv, d), np.float32)
    pos_pool = rng.integers(0, T, (N, bs)).astype(np.int32)   # stale pos
    table = np.full((b, nb_logical), -1, np.int32)
    for bi in range(b):
        for lb in range(nb_logical):
            phys = int(perm[bi * nb_logical + lb])
            table[bi, lb] = phys
            k_pool[phys] = k_lin[bi, lb * bs:(lb + 1) * bs]
            v_pool[phys] = v_lin[bi, lb * bs:(lb + 1) * bs]
            pos_pool[phys] = pos_lin[bi, lb * bs:(lb + 1) * bs]
    table[1, -1] = -1                       # one unmapped logical block
    # whose former physical block holds stale prior-context positions
    pos_pool[int(perm[2 * nb_logical - 1])] = rng.integers(0, max(start, 1),
                                                           bs)
    if g > 1:
        hi = -(-max(start, 1) // g)
        idx = np.full((b, 4), -1, np.int32)
        for bi in range(b):
            n = min(3, hi)
            idx[bi, :n] = rng.choice(hi, size=n, replace=False)
        idx[1, 0] = nb_logical * bs // g - 1    # a block of the -1 hole
    else:
        nsel = 24
        idx = np.full((b, n_kv, nsel), -1, np.int32)
        for bi in range(b):
            for hh in range(n_kv):
                n = min(nsel - 1, max(start, 1))
                idx[bi, hh, :n] = rng.choice(max(start + 2, 1), size=n,
                                             replace=False)
        idx[1, 0, 0] = T - 1                    # a slot of the -1 hole
    return q, k_pool, v_pool, pos_pool, table, idx


CASES = {
    # name: (g, chunk, start, seed)
    "g16_prefill": (16, 16, 96, 7),
    "g16_decode_misaligned": (16, 1, 101, 8),
    "g1_prefill": (1, 16, 96, 9),
    "g1_decode_misaligned": (1, 1, 77, 10),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_plain_matches_reference(name):
    g, chunk, start, seed = CASES[name]
    q, kp, vp, pp, table, idx = _paged_case(g, chunk, start, seed)
    n0 = sa_mod.PAGED_LAUNCHES
    got = ops.selected_attention(
        *map(torch.as_tensor, (q, kp, vp, pp, idx)), start, granularity=g,
        table=torch.as_tensor(table), block_size=16)
    assert sa_mod.PAGED_LAUNCHES == n0       # CPU tensors: no kernel
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    for backend in ("xla", "pallas_interpret"):
        want = ref_ops.selected_attention(
            *map(jnp.asarray, (q, kp, vp, pp, idx)), jnp.int32(start),
            granularity=g, backend=backend, table=jnp.asarray(table),
            block_size=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


def test_paged_matches_linear_route_on_the_linearized_pool():
    """Through the table or over the gathered view: the same function."""
    g, chunk, start, seed = CASES["g16_prefill"]
    q, kp, vp, pp, table, idx = map(torch.as_tensor,
                                    _paged_case(g, chunk, start, seed))
    paged = ops.selected_attention(q, kp, vp, pp, idx, start, granularity=g,
                                   table=table, block_size=16)
    k, v, key_pos = ref.linearize_pool(kp, vp, pp, table)
    linear = ops.selected_attention(q, k, v, key_pos, idx, start,
                                    granularity=g)
    torch.testing.assert_close(paged, linear, rtol=0, atol=0)


def test_linearize_pool_matches_reference():
    """Positions agree everywhere (unmapped blocks read -1); K/V agree on
    mapped blocks and are zero on the hole, as the pool's gather gives."""
    q, kp, vp, pp, table, idx = _paged_case(16, 16, 96, 7)
    k, v, pos = ref.linearize_pool(*map(torch.as_tensor, (kp, vp, pp,
                                                          table)))
    jk, jv, jpos = ref_ops._linearize_pool(*map(jnp.asarray, (kp, vp, pp,
                                                               table)))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    mapped = np.repeat(table >= 0, 16, axis=1)
    np.testing.assert_array_equal(k.numpy()[mapped], np.asarray(jk)[mapped])
    np.testing.assert_array_equal(v.numpy()[mapped], np.asarray(jv)[mapped])
    assert float(np.abs(k.numpy()[~mapped]).max()) == 0.0


def test_paged_needs_block_size_multiple_of_granularity():
    q, kp, vp, pp, table, idx = map(torch.as_tensor,
                                    _paged_case(16, 16, 96, 7))
    with pytest.raises(ValueError, match="multiple of the selection"):
        ops.selected_attention(q, kp, vp, pp, idx, 96, granularity=32,
                               table=table, block_size=16)


def test_table_entry_outside_pool_raises():
    """A host table naming a block past the pool raises before anything
    reads the pool (the kernel masks such an entry of a card-side table)."""
    q, kp, vp, pp, table, idx = map(torch.as_tensor,
                                    _paged_case(16, 16, 96, 7))
    table[0, 2] = kp.shape[0]
    with pytest.raises(ValueError, match="outside a pool"):
        ops.selected_attention(q, kp, vp, pp, idx, 96, granularity=16,
                               table=table, block_size=16)
