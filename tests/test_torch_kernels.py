"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the JAX reference: its production ``xla`` oracles AND its Pallas
kernels run with ``interpret=True``.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerance 2e-5 in fp32: the two sides differ only in summation order.
Geometries are taken from ``tests/test_kernels.py`` (FLASH_CASES,
SCORE_CASES, FUSED_CASES), a few of each since interpret mode is slow,
plus the fully-masked-row cases.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as ref_attention
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.flash_attention import flash_attention_bhtd as ref_flash
from repro.kernels.quoka_score import quoka_score_bhtd as ref_score
from repro_torch.core import attention
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_bhtd

torch.set_num_threads(2)

TOL = 2e-5


def _both(x):
    return jnp.asarray(x), torch.as_tensor(x)


def _close(port, want):
    np.testing.assert_allclose(port.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


FLASH_CASES = [
    # (b, h, h_kv, tq, tk, d, causal, boundary)
    (1, 4, 2, 128, 256, 64, True, 0),
    (1, 2, 1, 37, 119, 80, True, 16),       # ragged
    (1, 4, 4, 16, 300, 64, False, 0),       # cross attention
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_reference(case):
    b, h, hkv, tq, tk, d, causal, boundary = case
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, h, tq, d), np.float32)
    k = rng.standard_normal((b, hkv, tk, d), np.float32)
    v = rng.standard_normal((b, hkv, tk, d), np.float32)
    valid = rng.random((b, tk)) < 0.9
    (jq, tq_), (jk, tk_), (jv, tv), (jval, tval) = map(_both, (q, k, v, valid))
    got = flash_attention_bhtd(tq_, tk_, tv, tval, causal=causal,
                               boundary=boundary)
    _close(got, ref_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                            boundary=boundary, k_valid=jval))
    _close(got, ref_flash(jq, jk, jv, jval, causal=causal, boundary=boundary,
                          block_q=32, block_k=64))


MASKED_CASES = {
    # name: (b, h, hkv, tq, tk, d, causal, boundary, invalid-slot setter)
    "midstream_block_one_kv_head":
        (1, 4, 2, 32, 128, 16, True, 64, lambda m: m.__setitem__(
            (slice(None), 0, slice(32, 64)), False)),
    "one_kv_head_all_invalid":
        (1, 4, 2, 16, 64, 16, False, 0, lambda m: m.__setitem__(
            (slice(None), 0), False)),
    "causal_first_row_masked":
        (1, 2, 2, 8, 8, 16, True, 0, lambda m: m.__setitem__(
            (slice(None), slice(None), 0), False)),
}


@pytest.mark.parametrize("name", sorted(MASKED_CASES))
def test_flash_plain_masked_rows_match_reference(name):
    b, h, hkv, tq, tk, d, causal, boundary, mask_fn = MASKED_CASES[name]
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, h, tq, d), np.float32)
    k = rng.standard_normal((b, hkv, tk, d), np.float32)
    v = rng.standard_normal((b, hkv, tk, d), np.float32)
    valid = np.ones((b, hkv, tk), bool)
    mask_fn(valid)
    (jq, tq_), (jk, tk_), (jv, tv), (jval, tval) = map(_both, (q, k, v, valid))
    got = flash_attention_bhtd(tq_, tk_, tv, tval, causal=causal,
                               boundary=boundary)
    assert bool(torch.isfinite(got).all())
    _close(got, ref_flash(jq, jk, jv, jval, causal=causal, boundary=boundary,
                          block_q=16, block_k=32))
    _close(got, ref_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                            boundary=boundary, k_valid=jval))
    if name == "one_kv_head_all_invalid":
        assert float(got[:, : h // hkv].abs().max()) == 0.0
    if name == "causal_first_row_masked":
        assert float(got[:, :, 0].abs().max()) == 0.0


SCORE_CASES = [
    (2, 4, 16, 512, 64),
    (2, 2, 5, 100, 80),
    (1, 8, 1, 128, 128),      # single query (decode)
]


@pytest.mark.parametrize("case", SCORE_CASES)
def test_score_plain_matches_reference(case):
    b, nkv, nq, t, d = case
    rng = np.random.default_rng(2)
    qb = rng.standard_normal((b, nq, nkv, d), np.float32)
    qb /= np.linalg.norm(qb, axis=-1, keepdims=True)
    k = rng.standard_normal((b, t, nkv, d), np.float32)
    valid = rng.random((b, t)) < 0.8
    (jqb, tqb), (jk, tk_), (jval, tval) = map(_both, (qb, k, valid))
    got = ops.score(tqb, tk_, tval)
    assert got.shape == (b, nkv, t) and got.dtype == torch.float32
    _close(got, ref_ops._score_xla(jqb, jk, jval))
    _close(got, ref_score(jqb.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                          jval, block_t=128))


def test_score_proj_dim_not_yet_ported():
    z = torch.zeros((1, 2, 1, 64))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ops.score(z, torch.zeros((1, 8, 1, 64)), torch.ones((1, 8), dtype=bool),
                  proj_dim=16)


def _fused_case(case):
    """(q, k, v, key_pos, idx, start, g) as numpy, one geometry tuple of
    the reference's FUSED_CASES (plan ids include -1 padding and, at
    g == 1, slots at or past the chunk start)."""
    g, b, h, n_kv, T, chunk, start, nsel, seed = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, chunk, h, 16), np.float32)
    k = rng.standard_normal((b, T, n_kv, 16), np.float32)
    v = rng.standard_normal((b, T, n_kv, 16), np.float32)
    key_pos = np.arange(T, dtype=np.int32)[None].repeat(b, 0)
    if g > 1:
        hi = -(-max(start, 1) // g)
        idx = np.full((b, nsel), -1, np.int32)
        for bi in range(b):
            n = min(nsel - 1, hi)
            idx[bi, :n] = rng.choice(hi, size=n, replace=False)
    else:
        idx = np.full((b, n_kv, nsel), -1, np.int32)
        for bi in range(b):
            for hh in range(n_kv):
                n = min(nsel - 1, max(start, 1))
                idx[bi, hh, :n] = rng.choice(max(start + 2, 1), size=n,
                                             replace=False)
    return q, k, v, key_pos, idx, start, g


FUSED_CASES = [
    # (g, b, h, n_kv, T, chunk, start, n_sel_slots, seed)
    (16, 2, 4, 2, 256, 32, 52, 4, 1),      # ragged start straddles a block
    (16, 1, 4, 4, 128, 16, 0, 3, 2),       # first chunk: nothing selectable
    (16, 1, 2, 1, 256, 1, 37, 5, 3),       # decode: t=1, misaligned start
    (1, 1, 2, 2, 96, 32, 33, 17, 5),       # ragged chunk/boundary, g=1
]


@pytest.mark.parametrize("case", FUSED_CASES)
def test_selected_plain_matches_reference(case):
    q, k, v, key_pos, idx, start, g = _fused_case(case)
    if case[6] == 52:
        key_pos[:, 16:32] = -1             # a never-written cache block
    (jq, tq_), (jk, tk_), (jv, tv), (jp, tp), (ji, ti) = map(
        _both, (q, k, v, key_pos, idx))
    got = ops.selected_attention(tq_, tk_, tv, tp, ti, start, granularity=g)
    assert got.shape == tq_.shape and bool(torch.isfinite(got).all())
    for backend in ("xla", "pallas_interpret"):
        _close(got, ref_ops.selected_attention(jq, jk, jv, jp, ji,
                                               jnp.int32(start),
                                               granularity=g,
                                               backend=backend))


@pytest.mark.parametrize("tk", [300, 2600])
def test_dense_and_blocked_attention_match_reference(tk):
    """The kernel-free attention of the dense bypass and ``method="full"``:
    masked dense attention, and the online-softmax blocked form above
    BLOCKED_THRESHOLD keys; pad slots (pos -1) and a fully-masked query."""
    rng = np.random.default_rng(3)
    b, tq, h, hkv, d = 1, 16, 4, 2, 16
    q = rng.standard_normal((b, tq, h, d), np.float32)
    k = rng.standard_normal((b, tk, hkv, d), np.float32)
    v = rng.standard_normal((b, tk, hkv, d), np.float32)
    k_pos = np.arange(tk, dtype=np.int32)[None]
    k_pos[:, 5:40] = -1
    q_pos = np.arange(tk - tq, tk, dtype=np.int32)[None]
    q_pos[:, 0] = -5                       # attends nothing: zeros
    (jq, tq_), (jk, tk_), (jv, tv), (jqp, tqp), (jkp, tkp) = map(
        _both, (q, k, v, q_pos, k_pos))
    got = attention.attention_with_positions(tq_, tk_, tv, tqp, tkp)
    _close(got, ref_attention.attention_with_positions(jq, jk, jv, jqp, jkp))
    assert float(got[:, 0].abs().max()) == 0.0
