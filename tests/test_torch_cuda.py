"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``cuda``; on a host without a CUDA device each test skips
with the reason (the decision is taken inside a fixture, never at import).

Run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 2e-5 (summation order and expf differ); bf16 attention
one bf16 ulp of the largest output (both sides accumulate in fp32 and round
once at the end, so a rounding flip moves an element by at most one ulp of
its own size); scores are fp32 outputs of bf16 products, 1e-4.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import quoka_score as qs_mod
from repro_torch.kernels import ref
from repro_torch.kernels import selected_attention as sa_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "for sm_90a and run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(want, dtype):
    if dtype == torch.float32:
        return 2e-5
    top = float(want.float().abs().max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def _err(got, want):
    return float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (b, h, h_kv, tq, tk, d, causal, boundary, per_head_valid)
    (1, 32, 8, 128, 1152, 128, True, 1024, True),
    (1, 32, 8, 1, 1025, 128, True, 1024, True),
    (2, 4, 2, 37, 119, 64, True, 16, False),
    (1, 4, 4, 16, 300, 64, False, 0, False),
])
def test_flash_kernel_matches_plain(dev, case, dtype):
    b, h, hkv, tq, tk, d, causal, boundary, per_head = case
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b, tq, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, tk, hkv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, tk, hkv, d), generator=g, device=dev).to(dtype)
    shape = (b, hkv, tk) if per_head else (b, tk)
    valid = torch.rand(shape, generator=g, device=dev) < 0.9
    if per_head:
        valid[:, 0, :] = False                 # one KV head sees nothing
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    n0 = fa_mod.LAUNCHES
    got = fa_mod.flash_attention_bhtd(qt, kt, vt, valid, causal=causal,
                                      boundary=boundary)
    torch.cuda.synchronize()
    assert fa_mod.LAUNCHES == n0 + 1
    want = ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                   boundary=boundary, k_valid=valid)
    assert bool(torch.isfinite(got).all())
    assert _err(got, want) <= _tol(want, dtype)
    if per_head:
        assert float(got[:, : h // hkv].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(1, 8, 16, 8224, 128), (1, 8, 1, 8224, 128),
                                  (2, 2, 5, 100, 64)])
def test_score_kernel_matches_plain(dev, case, dtype):
    b, nkv, nq, t, d = case
    g = torch.Generator(device=dev).manual_seed(1)
    qb = torch.randn((b, nkv, nq, d), generator=g, device=dev)
    qb = qb / qb.norm(dim=-1, keepdim=True)
    k = torch.randn((b, t, nkv, d), generator=g, device=dev).to(dtype)
    valid = torch.rand((b, t), generator=g, device=dev) < 0.8
    kt = k.transpose(1, 2)
    n0 = qs_mod.LAUNCHES
    got = qs_mod.quoka_score_bhtd(qb, kt, valid)
    torch.cuda.synchronize()
    assert qs_mod.LAUNCHES == n0 + 1
    want = ref.score_ref(qb, kt, valid)
    assert _err(got, want) <= (1e-5 if dtype == torch.float32 else 1e-4)


def _plan(rng, g, b, n_kv, T, start, nsel):
    if g > 1:
        hi = -(-max(start, 1) // g)
        idx = np.full((b, nsel), -1, np.int32)
        for bi in range(b):
            n = min(nsel - 1, hi)
            idx[bi, :n] = rng.choice(hi, size=n, replace=False)
        return idx
    idx = np.full((b, n_kv, nsel), -1, np.int32)
    for bi in range(b):
        for hh in range(n_kv):
            n = min(nsel - 1, max(start, 1))
            idx[bi, hh, :n] = rng.choice(max(start + 2, 1), size=n,
                                         replace=False)
    return idx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (g, b, h, n_kv, T, t, start, n_sel, d)
    (16, 1, 32, 8, 8224, 128, 4096, 64, 128),   # main-path prefill chunk
    (16, 1, 32, 8, 8224, 1, 8197, 64, 128),     # decode, misaligned start
    (16, 2, 4, 2, 256, 32, 52, 4, 64),          # start straddles a block
    (16, 1, 4, 4, 128, 16, 0, 3, 64),           # nothing selectable
    (1, 1, 32, 8, 2048, 128, 1024, 1024, 128),  # token plan, per-head ids
    (1, 1, 2, 2, 96, 32, 33, 17, 64),           # ragged g=1
])
def test_selected_kernel_matches_plain(dev, case, dtype):
    gran, b, h, n_kv, T, t, start, nsel, d = case
    rng = np.random.default_rng(2)
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, T, n_kv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, T, n_kv, d), generator=g, device=dev).to(dtype)
    key_pos = torch.arange(T, dtype=torch.int32, device=dev).repeat(b, 1)
    key_pos[:, start + t:] = -1                # not yet written
    if T > 64:
        key_pos[:, 16:32] = -1                 # a never-written block
    idx = torch.as_tensor(_plan(rng, gran, b, n_kv, T, start, nsel),
                          device=dev)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    n0 = sa_mod.LAUNCHES
    got = sa_mod.selected_attention_bhtd(qt, kt, vt, key_pos, idx, start,
                                         granularity=gran)
    torch.cuda.synchronize()
    assert sa_mod.LAUNCHES == n0 + 1
    want = ref.selected_ref(q, k, v, key_pos, idx, start, gran).transpose(1, 2)
    assert bool(torch.isfinite(got).all())
    assert _err(got, want) <= _tol(want, dtype)


def test_unsupported_head_dim_raises(dev):
    x = torch.zeros((1, 2, 4, 96), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa_mod.flash_attention_bhtd(x, x, x)
