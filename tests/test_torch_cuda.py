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
    # bf16 tile (attn_mma.cuh): a GQA group per block at groups 1 and 8,
    # a 4224-key walk that wraps the K/V ring 66 times (256 blocks, no
    # split), and a non-causal group of 4
    (1, 8, 8, 128, 1152, 128, True, 1024, True),
    (2, 16, 2, 64, 700, 128, True, 600, True),
    (4, 32, 8, 128, 4224, 128, True, 4096, True),
    (1, 32, 8, 64, 1000, 128, False, 0, True),
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
@pytest.mark.parametrize("case", [
    # (b, n_kv, n_q, T, d[, "rows"])
    (1, 8, 16, 8224, 128), (1, 8, 1, 8224, 128), (2, 2, 5, 100, 64),
    # "rows": q̄ in the main path's (b, n_q, n_kv, d) layout viewed as
    # BHND; row 0 random validity, row 1 all invalid (exactly NEG_INF),
    # row 2 one valid run [37, 0.6 T) that tile boundaries cut; T not a
    # multiple of the tile; n_q blocks of 16 with an edge-padded tail
    (3, 8, 16, 8224, 128, "rows"), (3, 8, 1, 4133, 128, "rows"),
    (3, 2, 5, 300, 80, "rows"), (3, 2, 20, 300, 80, "rows"),
    (3, 4, 16, 1000, 64, "rows"), (3, 8, 20, 1000, 64, "rows"),
    (3, 1, 16, 300, 576, "rows"), (3, 2, 1, 77, 576, "rows"),
    (3, 1, 20, 700, 576, "rows"),
])
def test_score_kernel_matches_plain(dev, case, dtype):
    b, nkv, nq, t, d, *rows = case
    g = torch.Generator(device=dev).manual_seed(1)
    if rows:
        qb = torch.randn((b, nq, nkv, d), generator=g,
                         device=dev).transpose(1, 2)
    else:
        qb = torch.randn((b, nkv, nq, d), generator=g, device=dev)
    qb = qb / qb.norm(dim=-1, keepdim=True)
    k = torch.randn((b, t, nkv, d), generator=g, device=dev).to(dtype)
    valid = torch.rand((b, t), generator=g, device=dev) < 0.8
    if rows:
        valid[1] = False
        valid[2] = False
        valid[2, 37:int(0.6 * t)] = True
    kt = k.transpose(1, 2)
    n0 = qs_mod.LAUNCHES
    got = qs_mod.quoka_score_bhtd(qb, kt, valid)
    torch.cuda.synchronize()
    assert qs_mod.LAUNCHES == n0 + 1
    want = ref.score_ref(qb, kt, valid)
    assert _err(got, want) <= (1e-5 if dtype == torch.float32 else 1e-4)
    assert bool(torch.isfinite(got[valid[:, None].expand_as(got)]).all())
    assert bool((got[~valid[:, None].expand_as(got)] == ref.NEG_INF).all())
    if rows:
        assert bool((got[1] == ref.NEG_INF).all())


def test_score_call_launches_one_kernel(dev):
    """The wrapper leaves q̄'s rounding to the kernel: one call on CUDA
    tensors (fp32 q̄ in the main path's layout, a bf16 BTHD cache view)
    adds one launch, one kernel to a profiler trace and no torch op but
    the output's allocation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=dev).manual_seed(5)
    qb = torch.randn((1, 16, 8, 128), generator=g, device=dev).transpose(1, 2)
    qb = qb / qb.norm(dim=-1, keepdim=True)
    k = torch.randn((1, 8224, 8, 128), generator=g,
                    device=dev).to(torch.bfloat16)
    valid = torch.arange(8224, device=dev)[None] < 4096
    kt = k.transpose(1, 2)
    qs_mod.quoka_score_bhtd(qb, kt, valid)          # build and warm
    torch.cuda.synchronize()
    n0 = qs_mod.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        qs_mod.quoka_score_bhtd(qb, kt, valid)
        torch.cuda.synchronize()
    assert qs_mod.LAUNCHES == n0 + 1
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "score_kernel" in kernels[0], kernels
    ops = [e.name for e in prof.events() if e.name.startswith("aten::")
           and (e.cpu_parent is None
                or not e.cpu_parent.name.startswith("aten::"))]
    assert ops == ["aten::empty"], ops


def test_score_unsupported_shapes_raise(dev):
    """Head dims that are not a multiple of 8 in [8, 576], more queries
    than fit beside the ring, and a q̄ that is not fp32 (the kernel does
    the rounding itself) raise before any launch."""
    n0 = qs_mod.LAUNCHES
    valid = torch.ones((1, 64), dtype=bool, device=dev)
    for d, nq in ((68, 16), (592, 16), (4, 1), (576, 4096)):
        qb = torch.zeros((1, 2, nq, d), device=dev)
        k = torch.zeros((1, 2, 64, d), device=dev)
        with pytest.raises(ValueError, match="head dim|shared memory"):
            qs_mod.quoka_score_bhtd(qb, k, valid)
    k = torch.zeros((1, 2, 64, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        qs_mod.quoka_score_bhtd(k[:, :, :16], k, valid)
    assert qs_mod.LAUNCHES == n0


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
    (16, 1, 32, 4, 2048, 64, 1024, 32, 128),    # group of 8
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gran,t", [(16, 1), (1, 1), (16, 128)])
def test_selected_kernel_per_row_starts(dev, gran, t, dtype):
    """A serve step's geometry: 4 rows with their own starts (one of them
    idle: nothing written, no plan); at t = 1 the 32 (row, KV head) blocks
    split the key walk (S = 8 on an H100) and the merge runs."""
    b, h, n_kv, T, d, nsel = 4, 32, 8, 8320, 128, 64
    starts = [8190, 3000, 1030, 0]            # chunk ends <= T
    rng = np.random.default_rng(4)
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, T, n_kv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, T, n_kv, d), generator=g, device=dev).to(dtype)
    key_pos = torch.arange(T, dtype=torch.int32, device=dev).repeat(b, 1)
    idx = np.full((b, n_kv, nsel * 16) if gran == 1 else (b, nsel), -1,
                  np.int32)
    for bi, st in enumerate(starts):
        key_pos[bi, st + t:] = -1
        if st == 0:
            key_pos[bi] = -1                   # idle row
            continue
        one = _plan(rng, gran, 1, n_kv, T, st, idx.shape[-1])
        idx[bi] = one[0]
    idx = torch.as_tensor(idx, device=dev)
    st_dev = torch.as_tensor(starts, dtype=torch.int32, device=dev)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    n0 = sa_mod.LAUNCHES
    got = sa_mod.selected_attention_bhtd(qt, kt, vt, key_pos, idx, st_dev,
                                         granularity=gran)
    torch.cuda.synchronize()
    assert sa_mod.LAUNCHES == n0 + 1
    want = ref.selected_ref(q, k, v, key_pos, idx, st_dev,
                            gran).transpose(1, 2)
    assert bool(torch.isfinite(got).all())
    assert _err(got, want) <= _tol(want, dtype)
    assert float(got[3].abs().max()) == 0.0     # idle row: exact zeros


def _paged_inputs(dev, dtype, gran, t, start, d, bs=128, nb_logical=16,
                  n_kv=2, h=8, nsel=16):
    """A permuted pool holding two requests' linear views, spare blocks
    with stale positions, a -1 hole in row 1 whose former block keeps
    stale prior-context positions, and an idle row 2 (table all -1,
    start 0) like the idle rows of a serve step."""
    b, T = 3, nb_logical * bs
    N = 2 * nb_logical + 5
    rng = np.random.default_rng(3 + gran + t + d)
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    k_pool = torch.randn((N, bs, n_kv, d), generator=g, device=dev).to(dtype)
    v_pool = torch.randn((N, bs, n_kv, d), generator=g, device=dev).to(dtype)
    pos_pool = torch.as_tensor(rng.integers(0, T, (N, bs)), dtype=torch.int32,
                               device=dev)
    perm = rng.permutation(N)
    table = np.full((b, nb_logical), -1, np.int32)
    for bi in range(2):
        for lb in range(nb_logical):
            phys = int(perm[bi * nb_logical + lb])
            table[bi, lb] = phys
            p = np.arange(lb * bs, (lb + 1) * bs)
            pos_pool[phys] = torch.as_tensor(np.where(p < start + t, p, -1),
                                             device=dev)
    hole = nb_logical // 4
    table[1, hole] = -1
    pos_pool[int(perm[nb_logical + hole])] = torch.as_tensor(
        rng.integers(0, max(start, 1), bs), device=dev)
    starts = torch.as_tensor([start, start, 0], dtype=torch.int32,
                             device=dev)
    if gran > 1:
        hi = -(-max(start, 1) // gran)
        idx = np.full((b, nsel), -1, np.int32)
        for bi in range(2):
            n = min(nsel - 1, hi)
            idx[bi, :n] = rng.choice(hi, size=n, replace=False)
        idx[1, 0] = hole * bs // gran           # a block of the hole
    else:
        idx = np.full((b, n_kv, nsel * 16), -1, np.int32)
        for bi in range(2):
            for hh in range(n_kv):
                n = min(nsel * 16 - 1, max(start, 1))
                idx[bi, hh, :n] = rng.choice(max(start + 2, 1), size=n,
                                             replace=False)
        idx[1, :, 0] = hole * bs                # a slot of the hole
    return (q, k_pool, v_pool, pos_pool, torch.as_tensor(idx, device=dev),
            starts, torch.as_tensor(table, device=dev), bs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (g, t, start, d)
    (16, 128, 1024, 128),     # prefill chunk
    (16, 1, 1037, 128),       # decode, misaligned start
    (1, 128, 1024, 128),      # per-KV-head token plan
    (1, 1, 1037, 64),
    (16, 128, 0, 64),         # first chunk: nothing selectable
    (16, 1, 1037, 128, 8, 32),  # qwen3-4b heads: bf16 splits the walk (S=5)
])
def test_paged_kernel_matches_plain(dev, case, dtype):
    gran, t, start, d, *heads = case
    n_kv, h = heads or (2, 8)
    q, kp, vp, pp, idx, starts, table, bs = _paged_inputs(
        dev, dtype, gran, t, start, d, n_kv=n_kv, h=h)
    qt = q.transpose(1, 2)
    n0 = sa_mod.PAGED_LAUNCHES
    got = sa_mod.selected_attention_paged(qt, kp, vp, pp, idx, starts, table,
                                          granularity=gran, block_size=bs)
    torch.cuda.synchronize()
    assert sa_mod.PAGED_LAUNCHES == n0 + 1
    want = ref.selected_paged_ref(q, kp, vp, pp, idx, starts, table,
                                  gran).transpose(1, 2)
    assert bool(torch.isfinite(got).all())
    assert _err(got, want) <= _tol(want, dtype)
    assert float(got[2].abs().max()) == 0.0     # idle row: exact zeros
    # through the table == the linear kernel on the linearized pool
    k, v, key_pos = ref.linearize_pool(kp, vp, pp, table)
    lin = sa_mod.selected_attention_bhtd(qt, k.transpose(1, 2),
                                         v.transpose(1, 2), key_pos, idx,
                                         starts, granularity=gran)
    assert _err(got, lin) == 0.0


def test_paged_table_entry_outside_pool(dev):
    """An entry >= N in a table on the card is masked like -1 (no read past
    the pool); the same table on the host raises before any launch."""
    q, kp, vp, pp, idx, starts, table, bs = _paged_inputs(
        dev, torch.float32, 16, 128, 1024, 128)
    qt = q.transpose(1, 2)
    hole = int((table[1] < 0).nonzero()[0, 0])
    want = sa_mod.selected_attention_paged(qt, kp, vp, pp, idx, starts,
                                           table, granularity=16,
                                           block_size=bs)
    bad = table.clone()
    bad[1, hole] = kp.shape[0] + 3
    got = sa_mod.selected_attention_paged(qt, kp, vp, pp, idx, starts, bad,
                                          granularity=16, block_size=bs)
    torch.cuda.synchronize()
    assert _err(got, want) == 0.0
    n0 = sa_mod.PAGED_LAUNCHES
    with pytest.raises(ValueError, match="outside a pool"):
        sa_mod.selected_attention_paged(qt, kp, vp, pp, idx, starts,
                                        bad.cpu(), granularity=16,
                                        block_size=bs)
    assert sa_mod.PAGED_LAUNCHES == n0


@pytest.mark.parametrize("d", [12, 136])
def test_unsupported_head_dim_raises(dev, d):
    """Head dims the attention tiles do not take (not a multiple of 8, or
    past 128; flash's wide tile takes 576 alone) are refused before any
    launch."""
    x = torch.zeros((1, 2, 4, d), device=dev)
    n0 = (fa_mod.LAUNCHES, sa_mod.LAUNCHES, sa_mod.PAGED_LAUNCHES)
    with pytest.raises(ValueError, match="head dim"):
        fa_mod.flash_attention_bhtd(x, x, x)
    with pytest.raises(ValueError, match="head dim"):
        sa_mod.selected_attention_bhtd(
            x, x, x, torch.zeros((1, 4), dtype=torch.int32, device=dev),
            torch.zeros((1, 1), dtype=torch.int32, device=dev), 0,
            granularity=4)
    pool = torch.zeros((2, 16, 2, d), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        sa_mod.selected_attention_paged(
            x, pool, pool, torch.zeros((2, 16), dtype=torch.int32,
                                       device=dev),
            torch.zeros((1, 1), dtype=torch.int32, device=dev), 0,
            torch.zeros((1, 2), dtype=torch.int32, device=dev),
            granularity=16, block_size=16)
    assert (fa_mod.LAUNCHES, sa_mod.LAUNCHES, sa_mod.PAGED_LAUNCHES) == n0


# every head dim the tiles take is built at the next multiple of 16: 8 and
# 120 are padded (Q and K zero-filled), 80 and 112 leave a row's last
# chunks unswizzled; groups 1 (MHA: stablelm), 3 (llama3-2-3b), 7
HEAD_DIM_CASES = [(d, h, n_kv) for d in (8, 32, 80, 112, 120)
                  for h, n_kv in ((4, 4), (6, 2), (14, 2))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,n_kv", HEAD_DIM_CASES)
def test_flash_kernel_at_every_head_dim(dev, d, h, n_kv, dtype):
    """Prefill (a split-free 300-key walk) and decode (a split walk) at
    head dims off the old 64 / 128; a KV head with no valid key gives
    exact zeros."""
    g = torch.Generator(device=dev).manual_seed(d + h)
    for tq, tk, boundary in ((64, 300, 200), (1, 1025, 1024)):
        q = torch.randn((2, h, tq, d), generator=g, device=dev).to(dtype)
        k = torch.randn((2, n_kv, tk, d), generator=g, device=dev).to(dtype)
        v = torch.randn((2, n_kv, tk, d), generator=g, device=dev).to(dtype)
        valid = torch.rand((2, n_kv, tk), generator=g, device=dev) < 0.9
        valid[1, 0] = False                    # nothing to attend
        got = fa_mod.flash_attention_bhtd(q, k, v, valid, causal=True,
                                          boundary=boundary)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, causal=True,
                                       boundary=boundary, k_valid=valid)
        assert bool(torch.isfinite(got).all())
        assert _err(got, want) <= _tol(want, dtype)
        assert float(got[1, : h // n_kv].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,n_kv", HEAD_DIM_CASES)
def test_selected_and_paged_kernels_at_every_head_dim(dev, d, h, n_kv,
                                                      dtype):
    """Linear selected attention (g = 16 prefill, g = 1 decode) and the
    paged kernel on the same pool at head dims off the old 64 / 128: each
    matches its plain version, an idle row is exact zeros, and the paged
    kernel equals the linear one bit for bit."""
    for gran, t, start in ((16, 64, 1024), (1, 1, 1037)):
        q, kp, vp, pp, idx, starts, table, bs = _paged_inputs(
            dev, dtype, gran, t, start, d, n_kv=n_kv, h=h)
        qt = q.transpose(1, 2)
        got = sa_mod.selected_attention_paged(
            qt, kp, vp, pp, idx, starts, table, granularity=gran,
            block_size=bs)
        k, v, key_pos = ref.linearize_pool(kp, vp, pp, table)
        lin = sa_mod.selected_attention_bhtd(
            qt, k.transpose(1, 2), v.transpose(1, 2), key_pos, idx, starts,
            granularity=gran)
        torch.cuda.synchronize()
        want = ref.selected_ref(q, k, v, key_pos, idx, starts,
                                gran).transpose(1, 2)
        assert bool(torch.isfinite(got).all())
        assert _err(lin, want) <= _tol(want, dtype)
        assert float(lin[2].abs().max()) == 0.0     # idle row
        assert _err(got, lin) == 0.0


def test_host_tier_pinned_round_trip_on_side_stream(dev):
    """On the card the host tier's rows are pinned; a demotion copies a
    block out on the compute stream, ``stage`` copies it back on a side
    stream, and the promotion that consumes the staged copy writes the
    block's bytes back unchanged; an unstaged promotion does too."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving.pool import PagedKVCache
    cfg = dataclasses.replace(get_config("llama3-2-3b").smoke(),
                              dtype=torch.bfloat16)
    model = build_model(cfg, device=dev)
    pool = PagedKVCache(model, num_blocks=3, block_size=16,
                        host_tier_blocks=4)
    assert pool.host.store.is_pinned()
    toks = np.arange(32, dtype=np.int32) + 3
    pool.alloc(0, 2)
    donor = list(pool.table(0))
    g = torch.Generator(device=dev).manual_seed(0)
    for st in pool.data:
        for kv in st:
            kv.k[donor] = torch.randn(kv.k[donor].shape, generator=g,
                                      device=dev).to(kv.k.dtype)
            kv.v[donor] = torch.randn(kv.v[donor].shape, generator=g,
                                      device=dev).to(kv.v.dtype)
            kv.pos[donor] = torch.arange(32, dtype=torch.int32,
                                         device=dev).view(2, 16)
    pool.register_prefix(0, toks)
    want = [leaf[donor].clone() for st in pool.data for kv in st
            for leaf in kv]
    pool.free(0)
    pool.alloc(1, 3)                         # demotes both blocks
    pool.free(1)
    fulls, _ = pool.match_prefix(toks)
    assert all(isinstance(e, tuple) for e in fulls) and pool.demoted == 2
    assert pool.stage(fulls[0][1]) == 1      # staged; the second is not
    side = pool._side
    assert side is not None and side != torch.cuda.current_stream(dev)
    table = pool.alloc_prefix(2, 3, shared=fulls)
    torch.cuda.synchronize()
    assert pool.promoted == 2 and pool.staged_used == 1
    got = [leaf[table[:2]] for st in pool.data for kv in st for leaf in kv]
    for w, x in zip(want, got):
        assert torch.equal(w, x)
    pool.check_invariants()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,nq", [(32, 16), (32, 1), (64, 16), (64, 1)])
def test_score_kernel_at_projected_dims(dev, r, nq, dtype):
    """Low-rank scoring (``score_proj_dim``): q̄ and K projected from
    d = 128 to r, then the scoring kernel at head dim r, against the plain
    version on the same projected inputs."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(3)
    qb = torch.randn((1, nq, 8, 128), generator=g, device=dev)
    qb = qb / qb.norm(dim=-1, keepdim=True)
    k = torch.randn((1, 8224, 8, 128), generator=g, device=dev).to(dtype)
    valid = torch.arange(8224, device=dev)[None] < 4096
    proj = ops.score_projection(128, r, dev)
    n0 = qs_mod.LAUNCHES
    got = ops.score(qb, k, valid, proj=proj)
    torch.cuda.synchronize()
    assert qs_mod.LAUNCHES == n0 + 1
    qp, kp = qb.float() @ proj, k @ proj.to(dtype)
    want = ref.score_ref(qp.transpose(1, 2), kp.transpose(1, 2), valid)
    assert _err(got, want) <= (1e-5 if dtype == torch.float32 else 1e-4)
    assert bool((got[:, :, 4096:] == ref.NEG_INF).all())


def test_score_projection_rank_the_kernel_cannot_take_raises(dev):
    """r = 20 is no multiple of 8: the card raises (the CPU's plain
    version takes any r)."""
    from repro_torch.kernels import ops
    qb = torch.randn((1, 4, 2, 64), device=dev)
    k = torch.randn((1, 100, 2, 64), device=dev)
    valid = torch.ones((1, 100), dtype=torch.bool, device=dev)
    n0 = qs_mod.LAUNCHES
    with pytest.raises(ValueError, match="head dim"):
        ops.score(qb, k, valid, proj=ops.score_projection(64, 20, dev))
    assert qs_mod.LAUNCHES == n0
    ops.score(qb.cpu(), k.cpu(), valid.cpu(),
              proj=ops.score_projection(64, 20))


HARNESS_METHODS = ("quoka", "sample_attention", "sparq", "loki",
                   "less_is_more", "snapkv", "keydiff", "full")


@pytest.mark.parametrize("route", ["staged_g1", "fused_g16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("method", HARNESS_METHODS)
def test_harness_on_the_card_matches_cpu(dev, method, dtype, route):
    """The chunked-prefill harness at b = 2, T = 512, h = 8, n_kv = 2,
    d = 64 (chunk 128, budget 64): the card (scoring, flash and selected
    kernels) gives the CPU's outputs and recalls, and launches its
    attention kernel on every chunk."""
    import dataclasses
    from repro_torch.configs.base import QuokaConfig
    from repro_torch.core import chunked_prefill as cp
    from repro_torch.data.synthetic import structured_qkv
    fused = route == "fused_g16"
    cfg = QuokaConfig(chunk_size=128, budget=64, n_queries=16, keep_first=4)
    if fused:
        cfg = dataclasses.replace(cfg, granularity=16, fused_select_attn=True)
    cpu = [x.to(dtype) for x in structured_qkv(3, 2, 512, 8, 2, 64)]
    card = [x.to(dev) for x in cpu]
    fa_mod.LAUNCHES = sa_mod.LAUNCHES = qs_mod.LAUNCHES = 0
    got = cp.chunked_sparse_attention(*card, cfg, method)
    torch.cuda.synchronize()
    launches = (fa_mod.LAUNCHES, sa_mod.LAUNCHES, qs_mod.LAUNCHES)
    want = cp.chunked_sparse_attention(*cpu, cfg, method)
    assert _err(got.cpu(), want) <= _tol(want, dtype)
    if method == "full":
        assert launches == (0, 0, 0)
        return
    attn = (0, 4) if fused else (4, 0)
    assert launches == attn + ((4 if method == "quoka" else 0),)
    for fn in (cp.key_recall, cp.critical_key_recall):
        assert float(fn(*card, cfg, method)) == float(fn(*cpu, cfg, method))


def test_sample_positions_on_the_card_match_cpu(dev):
    """SampleAttention's query rows are built on the card; its float32
    product and truncation give the CPU's rows for every t in 1..1024 and
    n in 1..32 (which equal the reference's, see test_torch_baselines)."""
    from repro_torch.core.selection import sample_positions
    for n in range(1, 33):
        for t in range(1, 1025):
            got = sample_positions(t, n, dev)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), sample_positions(t, n)), (t, n)


def _mla_flash_inputs(dev, dtype, tq, tk, boundary, h=128, seed=0):
    """MLA's flash call: absorbed queries (2, h, tq, 576) over one latent KV
    head of [latent | rope] keys (2, 1, tk, 576); V is the 512-wide latent
    (the keys' first 512 columns, a strided view, as MLABlock passes it).
    Row 1 has no valid budget key and its first four chunk keys invalid,
    so its first four query rows attend nothing."""
    g = torch.Generator(device=dev).manual_seed(tq + tk)
    q = torch.randn((2, h, tq, 576), generator=g, device=dev).to(dtype)
    k = torch.randn((2, 1, tk, 576), generator=g, device=dev).to(dtype)
    valid = torch.rand((2, tk), generator=g, device=dev) < 0.9
    valid[1, :boundary] = False
    valid[1, boundary:boundary + 4] = False
    return q, k, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dv", [576, 512])
@pytest.mark.parametrize("tq,tk,boundary", [(128, 1152, 1024),
                                            (1, 1025, 1024)])
def test_flash_kernel_at_mla_width(dev, tq, tk, boundary, dv, dtype):
    """deepseek-v3's shapes (prefill and decode, 128 heads over one latent
    head, scale 1/sqrt(192)) on the wide tile: V 576 wide (the reference's
    zero-padded latent, here random) or 512 (the latent itself); rows with
    no valid key give exact zeros; at dv = 512 the output equals the
    576-wide call on the zero-padded V, sliced to 512 columns."""
    q, k, valid = _mla_flash_inputs(dev, dtype, tq, tk, boundary)
    v = k[..., :dv]
    scale = 192 ** -0.5
    n0 = fa_mod.LAUNCHES
    got = fa_mod.flash_attention_bhtd(q, k, v, valid, causal=True,
                                      boundary=boundary, scale=scale)
    torch.cuda.synchronize()
    assert fa_mod.LAUNCHES == n0 + 1 and got.shape == (2, 128, tq, dv)
    want = ref.flash_attention_ref(q, k, v, causal=True, boundary=boundary,
                                   k_valid=valid, scale=scale)
    assert bool(torch.isfinite(got).all())
    assert _err(got, want) <= _tol(want, dtype)
    assert float(got[1, :, :4].abs().max()) == 0.0
    if dv == 512:
        v_pad = torch.nn.functional.pad(v, (0, 576 - dv))
        pad = fa_mod.flash_attention_bhtd(q, k, v_pad, valid, causal=True,
                                          boundary=boundary, scale=scale)
        assert _err(got, pad[..., :dv]) <= _tol(want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv,h,n_kv", [(576, 576, 4, 2), (576, 128, 8, 1),
                                         (576, 48, 4, 4), (64, 32, 6, 2),
                                         (128, 8, 4, 4)])
def test_flash_kernel_wide_and_narrow_values(dev, d, dv, h, n_kv, dtype):
    """The wide tile at other GQA groups and V widths (a whole, a single
    and a partial column slice) and V narrower than the keys on the
    narrow tile, prefill and a split decode walk; a KV head with no valid
    key gives exact zeros."""
    g = torch.Generator(device=dev).manual_seed(d + dv)
    for tq, tk, boundary in ((64, 300, 200), (1, 1025, 1024)):
        q = torch.randn((2, h, tq, d), generator=g, device=dev).to(dtype)
        k = torch.randn((2, n_kv, tk, d), generator=g, device=dev).to(dtype)
        v = torch.randn((2, n_kv, tk, dv), generator=g, device=dev).to(dtype)
        valid = torch.rand((2, n_kv, tk), generator=g, device=dev) < 0.9
        valid[1, 0] = False
        got = fa_mod.flash_attention_bhtd(q, k, v, valid, causal=True,
                                          boundary=boundary)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, causal=True,
                                       boundary=boundary, k_valid=valid)
        assert got.shape == (2, h, tq, dv)
        assert _err(got, want) <= _tol(want, dtype)
        assert float(got[1, : h // n_kv].abs().max()) == 0.0


def test_flash_value_wider_than_keys_raises(dev):
    """V wider than the keys, or not a multiple of 8, is refused before a
    launch."""
    q = torch.zeros((1, 2, 4, 64), device=dev)
    n0 = fa_mod.LAUNCHES
    for dv in (72, 20):
        v = torch.zeros((1, 2, 4, dv), device=dev)
        with pytest.raises(ValueError, match="value width"):
            fa_mod.flash_attention_bhtd(q, q, v)
    assert fa_mod.LAUNCHES == n0


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_capacity_layer_on_the_card_matches_cpu(dev, arch):
    """One MoE layer's capacity dispatch (capacity factor 0.5, so pairs
    drop) on the card against the same plain code on the CPU, fp32: the
    router picks the same experts, the same (token, choice) pairs drop,
    and the outputs agree within 1e-4 relative."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    base = get_config(arch).smoke()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, dispatch="capacity", capacity_factor=0.5))
    gen = torch.Generator().manual_seed(0)
    cpu = moe.MoE(cfg, "cpu")
    cpu.init(lambda p, std: p.copy_(torch.randn(p.shape, generator=gen)
                                    * std))
    gpu = moe.MoE(cfg, dev)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 24, cfg.d_model), generator=gen)
    want = moe.moe_apply(cpu, x, cfg)
    got = moe.moe_apply(gpu, x.to(dev), cfg)
    torch.cuda.synchronize()
    xf = x.reshape(-1, cfg.d_model)
    _, ids_c, _ = moe.route(cpu, xf, cfg.moe)
    _, ids_g, _ = moe.route(gpu, xf.to(dev), cfg.moe)
    assert torch.equal(ids_g.cpu(), ids_c)
    cap = moe.capacity(cfg.moe, xf.shape[0])
    keep_c = moe.capacity_slots(ids_c, cfg.moe.n_experts, cap)[2]
    keep_g = moe.capacity_slots(ids_g, cfg.moe.n_experts, cap)[2]
    assert torch.equal(keep_g.cpu(), keep_c) and not bool(keep_c.all())
    rel = _err(got.cpu(), want) / float(want.abs().max())
    assert rel <= 1e-4


# ---------------------------------------------------------------------------
# the sliding-window slice: scoring off the 16-grid (h2o-danube's d = 120),
# gemma3's global attention shapes, MLA's latent slabs in the host tier,
# and the two windowed models end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 24, 40, 56, 72, 88, 104, 120, 136, 568])
@pytest.mark.parametrize("nq", [16, 1, 20])
def test_score_kernel_at_widths_off_the_16_grid(dev, d, nq, dtype):
    """Head dims that are a multiple of 8 but not of 16 are staged at the
    next multiple of 16 with the missing columns of K's ring and of q̄
    zero-filled: the scores equal the plain version's; a row with no valid
    slot is exactly NEG_INF."""
    b, nkv, t = 3, 2, 300
    g = torch.Generator(device=dev).manual_seed(d + nq)
    qb = torch.randn((b, nq, nkv, d), generator=g, device=dev).transpose(1, 2)
    qb = qb / qb.norm(dim=-1, keepdim=True)
    k = torch.randn((b, t, nkv, d), generator=g, device=dev).to(dtype)
    valid = torch.rand((b, t), generator=g, device=dev) < 0.8
    valid[1] = False
    kt = k.transpose(1, 2)
    n0 = qs_mod.LAUNCHES
    got = qs_mod.quoka_score_bhtd(qb, kt, valid)
    torch.cuda.synchronize()
    assert qs_mod.LAUNCHES == n0 + 1
    want = ref.score_ref(qb, kt, valid)
    assert _err(got, want) <= (1e-5 if dtype == torch.float32 else 1e-4)
    assert bool((got[1] == ref.NEG_INF).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq", [16, 1])
def test_score_kernel_on_a_wrapped_ring_at_d120(dev, nq, dtype):
    """h2o-danube-3-4b's scoring call: a ring of 4096 slots (n_kv 8,
    d 120) whose positions wrap mid-ring, the chunk's own 128 slots
    invalid, against the plain version."""
    T, start = 4096, 6016
    g = torch.Generator(device=dev).manual_seed(nq)
    qb = torch.randn((1, 8, nq, 120), generator=g, device=dev)
    qb = qb / qb.norm(dim=-1, keepdim=True)
    k = torch.randn((1, T, 8, 120), generator=g, device=dev).to(dtype)
    last = start + 127
    pos = last - (last - torch.arange(T, device=dev)) % T
    valid = ((pos >= 0) & (pos < start))[None]
    kt = k.transpose(1, 2)
    got = qs_mod.quoka_score_bhtd(qb, kt, valid)
    want = ref.score_ref(qb, kt, valid)
    assert _err(got, want) <= (1e-5 if dtype == torch.float32 else 1e-4)
    assert bool((got[:, :, ~valid[0]] == ref.NEG_INF).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq", [128, 1])
def test_attention_at_gemma3_global_shapes(dev, tq, dtype):
    """gemma3-27b's global layers: 32 query heads over 16 KV heads (GQA
    group 2), a budget of 2048: flash over [2048 | tq] keys (2176 at a
    prefill chunk) and selected attention through 128 plan blocks of 16,
    each against its plain version."""
    h, n_kv, d, B = 32, 16, 128, 2048
    g = torch.Generator(device=dev).manual_seed(tq)
    q = torch.randn((1, tq, h, d), generator=g, device=dev).to(dtype)
    tk = B + tq
    k = torch.randn((1, tk, n_kv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((1, tk, n_kv, d), generator=g, device=dev).to(dtype)
    valid = torch.rand((1, n_kv, tk), generator=g, device=dev) < 0.9
    valid[:, :, B:] = True
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = fa_mod.flash_attention_bhtd(qt, kt, vt, valid, causal=True,
                                      boundary=B)
    want = ref.flash_attention_ref(qt, kt, vt, causal=True, boundary=B,
                                   k_valid=valid)
    assert _err(got, want) <= _tol(want, dtype)
    T, start = 8224, 4096 if tq > 1 else 8197
    rng = np.random.default_rng(tq)
    k = torch.randn((1, T, n_kv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((1, T, n_kv, d), generator=g, device=dev).to(dtype)
    key_pos = torch.arange(T, dtype=torch.int32, device=dev)[None].clone()
    key_pos[:, start + tq:] = -1
    idx = torch.as_tensor(_plan(rng, 16, 1, n_kv, T, start, B // 16),
                          device=dev)
    got = sa_mod.selected_attention_bhtd(qt, k.transpose(1, 2),
                                         v.transpose(1, 2), key_pos, idx,
                                         start, granularity=16)
    want = ref.selected_ref(q, k, v, key_pos, idx, start, 16).transpose(1, 2)
    assert idx.shape == (1, 128)
    assert _err(got, want) <= _tol(want, dtype)


def test_host_tier_latent_slab_round_trip(dev):
    """deepseek-v3's latent caches in the pool on the card: a latent block
    is demoted into a pinned slab (latent rows, then positions), staged
    back on the side stream and promoted bit for bit; an unstaged
    promotion too."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving.cache import LatentCache
    from repro_torch.serving.pool import PagedKVCache
    cfg = dataclasses.replace(get_config("deepseek-v3-671b").smoke(),
                              dtype=torch.bfloat16)
    model = build_model(cfg, device=dev)
    pool = PagedKVCache(model, num_blocks=3, block_size=16,
                        host_tier_blocks=4)
    assert pool.host.store.is_pinned()
    assert all(isinstance(c, LatentCache) for st in pool.data for c in st)
    toks = np.arange(32, dtype=np.int32) + 3
    pool.alloc(0, 2)
    donor = list(pool.table(0))
    g = torch.Generator(device=dev).manual_seed(0)
    for st in pool.data:
        for c in st:
            c.latent[donor] = torch.randn(c.latent[donor].shape, generator=g,
                                          device=dev).to(c.latent.dtype)
            c.pos[donor] = torch.arange(32, dtype=torch.int32,
                                        device=dev).view(2, 16)
    pool.register_prefix(0, toks)
    want = [leaf[donor].clone() for st in pool.data for c in st
            for leaf in (c.latent, c.pos)]
    pool.free(0)
    pool.alloc(1, 3)                         # demotes both blocks
    pool.free(1)
    fulls, _ = pool.match_prefix(toks)
    assert all(isinstance(e, tuple) for e in fulls) and pool.demoted == 2
    assert pool.stage(fulls[0][1]) == 1
    table = pool.alloc_prefix(2, 3, shared=fulls)
    torch.cuda.synchronize()
    assert pool.promoted == 2 and pool.staged_used == 1
    got = [leaf[table[:2]] for st in pool.data for c in st
           for leaf in (c.latent, c.pos)]
    for w, x in zip(want, got):
        assert torch.equal(w, x)
    pool.check_invariants()


@pytest.mark.parametrize("route", ["staged_g1", "fused_g16"])
@pytest.mark.parametrize("arch", ["gemma3-27b", "h2o-danube-3-4b"])
def test_window_models_on_the_card_match_cpu(dev, arch, route):
    """The smoke configs (window 64) in fp32 at prompt 160, so every ring
    wraps: the card (scoring kernel; flash or selected attention on
    gemma3's global layer) gives the CPU's prefill logits within 1e-4 and
    its greedy tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, build_model
    from repro_torch.serving.engine import Engine
    base = get_config(arch).smoke()
    qover = {} if route == "staged_g1" else dict(granularity=16,
                                                 fused_select_attn=True)
    cfg = dataclasses.replace(base, quoka=dataclasses.replace(base.quoka,
                                                              **qover))
    cpu = build_model(cfg, device="cpu", seed=3)
    gpu = Model(cfg, dev)
    gpu.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(3).integers(3, cfg.vocab,
                                             (2, 160)).astype(np.int32)
    n0 = qs_mod.LAUNCHES
    lg, _ = gpu.prefill({"tokens": toks}, gpu.init_cache(2, 176))
    lc, _ = cpu.prefill({"tokens": toks}, cpu.init_cache(2, 176))
    assert qs_mod.LAUNCHES > n0
    assert _err(lg.cpu(), lc) <= 1e-4
    tg = Engine(gpu).generate({"tokens": toks}, 8).tokens
    tc = Engine(cpu, device="cpu").generate({"tokens": toks}, 8).tokens
    np.testing.assert_array_equal(tg, tc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq", [128, 1])
def test_kernels_at_zamba2_shared_block_shapes(dev, tq, dtype):
    """zamba2-7b's shared attention block (MHA 32 / 32, d 112) at prompt
    8192 + 32: scoring over the 8224-slot cache (n_q 16 at a prefill
    chunk, 1 at decode), flash over [1024 | tq] keys and selected
    attention through 64 plan blocks of 16, each against its plain
    version."""
    h = n_kv = 32
    d, B, T = 112, 1024, 8224
    start = 4096 if tq > 1 else 8197
    g = torch.Generator(device=dev).manual_seed(112 + tq)
    nq = 16 if tq > 1 else 1
    qb = torch.randn((1, n_kv, nq, d), generator=g, device=dev)
    qb = qb / qb.norm(dim=-1, keepdim=True)
    k = torch.randn((1, T, n_kv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((1, T, n_kv, d), generator=g, device=dev).to(dtype)
    key_pos = torch.arange(T, dtype=torch.int32, device=dev)[None].clone()
    key_pos[:, start + tq:] = -1
    valid = (key_pos >= 0) & (key_pos < start)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    got = qs_mod.quoka_score_bhtd(qb, kt, valid)
    want = ref.score_ref(qb, kt, valid)
    assert _err(got, want) <= (1e-5 if dtype == torch.float32 else 1e-4)
    assert bool((got[:, :, ~valid[0]] == ref.NEG_INF).all())
    q = torch.randn((1, tq, h, d), generator=g, device=dev).to(dtype)
    qt = q.transpose(1, 2)
    kc = torch.randn((1, n_kv, B + tq, d), generator=g, device=dev).to(dtype)
    vc = torch.randn((1, n_kv, B + tq, d), generator=g, device=dev).to(dtype)
    kv_ok = torch.rand((1, n_kv, B + tq), generator=g, device=dev) < 0.9
    kv_ok[:, :, B:] = True
    got = fa_mod.flash_attention_bhtd(qt, kc, vc, kv_ok, causal=True,
                                      boundary=B)
    want = ref.flash_attention_ref(qt, kc, vc, causal=True, boundary=B,
                                   k_valid=kv_ok)
    assert _err(got, want) <= _tol(want, dtype)
    rng = np.random.default_rng(tq)
    idx = torch.as_tensor(_plan(rng, 16, 1, n_kv, T, start, B // 16),
                          device=dev)
    got = sa_mod.selected_attention_bhtd(qt, kt, vt, key_pos, idx, start,
                                         granularity=16)
    want = ref.selected_ref(q, k, v, key_pos, idx, start, 16).transpose(1, 2)
    assert _err(got, want) <= _tol(want, dtype)


@pytest.mark.parametrize("arch,route", [("zamba2-7b", "staged_g1"),
                                        ("zamba2-7b", "fused_g16"),
                                        ("rwkv6-1.6b", "staged_g1")])
def test_recurrent_models_on_the_card_match_cpu(dev, arch, route):
    """The smoke configs in fp32 at prompt 160: the card (zamba2's shared
    block on the scoring kernel and flash or selected attention; rwkv6 on
    no kernel) gives the CPU's prefill logits within 1e-4 and its greedy
    tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, build_model
    from repro_torch.serving.engine import Engine
    base = get_config(arch).smoke()
    qover = {} if route == "staged_g1" else dict(granularity=16,
                                                 fused_select_attn=True)
    cfg = dataclasses.replace(base, quoka=dataclasses.replace(base.quoka,
                                                              **qover))
    cpu = build_model(cfg, device="cpu", seed=3)
    gpu = Model(cfg, dev)
    gpu.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(3).integers(3, cfg.vocab,
                                             (2, 160)).astype(np.int32)
    n0 = qs_mod.LAUNCHES
    lg, _ = gpu.prefill({"tokens": toks}, gpu.init_cache(2, 176))
    lc, _ = cpu.prefill({"tokens": toks}, cpu.init_cache(2, 176))
    assert (qs_mod.LAUNCHES > n0) == (arch == "zamba2-7b")
    assert _err(lg.cpu(), lc) <= 1e-4
    tg = Engine(gpu).generate({"tokens": toks}, 8).tokens
    tc = Engine(cpu, device="cpu").generate({"tokens": toks}, 8).tokens
    np.testing.assert_array_equal(tg, tc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq", [128, 1])
@pytest.mark.parametrize("h,n_kv,B", [(12, 12, 512), (14, 2, 1024)])
def test_kernels_at_modality_shapes(dev, h, n_kv, B, tq, dtype):
    """whisper-small's decoder self-attention (MHA 12 / 12, d 64, budget
    512) and internvl2-1b's LM (GQA 14 / 2, a group of 7, d 64, budget
    1024) at 8192 + 32 positions: scoring over the 8224-slot cache (n_q 16
    at a prefill chunk, 1 at decode), flash over [B | tq] keys and
    selected attention through B / 16 plan blocks, each against its plain
    version; a KV head whose budget and first chunk key are invalid gives
    exact zeros in query row 0 of its group."""
    d, T = 64, 8224
    group = h // n_kv
    start = 4096 if tq > 1 else 8197
    g = torch.Generator(device=dev).manual_seed(64 + h + tq)
    nq = 16 if tq > 1 else 1
    qb = torch.randn((1, n_kv, nq, d), generator=g, device=dev)
    qb = qb / qb.norm(dim=-1, keepdim=True)
    k = torch.randn((1, T, n_kv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((1, T, n_kv, d), generator=g, device=dev).to(dtype)
    key_pos = torch.arange(T, dtype=torch.int32, device=dev)[None].clone()
    key_pos[:, start + tq:] = -1
    valid = (key_pos >= 0) & (key_pos < start)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    got = qs_mod.quoka_score_bhtd(qb, kt, valid)
    want = ref.score_ref(qb, kt, valid)
    assert _err(got, want) <= (1e-5 if dtype == torch.float32 else 1e-4)
    assert bool((got[:, :, ~valid[0]] == ref.NEG_INF).all())
    q = torch.randn((1, tq, h, d), generator=g, device=dev).to(dtype)
    qt = q.transpose(1, 2)
    kc = torch.randn((1, n_kv, B + tq, d), generator=g, device=dev).to(dtype)
    vc = torch.randn((1, n_kv, B + tq, d), generator=g, device=dev).to(dtype)
    kv_ok = torch.rand((1, n_kv, B + tq), generator=g, device=dev) < 0.9
    kv_ok[:, :, B:] = True
    kv_ok[:, n_kv - 1, :B + 1] = False
    got = fa_mod.flash_attention_bhtd(qt, kc, vc, kv_ok, causal=True,
                                      boundary=B)
    want = ref.flash_attention_ref(qt, kc, vc, causal=True, boundary=B,
                                   k_valid=kv_ok)
    assert _err(got, want) <= _tol(want, dtype)
    assert float(got[:, (n_kv - 1) * group:, 0].abs().max()) == 0.0
    rng = np.random.default_rng(tq + h)
    idx = torch.as_tensor(_plan(rng, 16, 1, n_kv, T, start, B // 16),
                          device=dev)
    got = sa_mod.selected_attention_bhtd(qt, kt, vt, key_pos, idx, start,
                                         granularity=16)
    want = ref.selected_ref(q, k, v, key_pos, idx, start, 16).transpose(1, 2)
    assert _err(got, want) <= _tol(want, dtype)


@pytest.mark.parametrize("route", ["staged_g1", "fused_g16"])
@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b"])
def test_modality_models_on_the_card_match_cpu(dev, arch, route):
    """The smoke configs in fp32 at 160 positions (whisper: 160 decoder
    tokens over 64 frames; internvl2: 16 patches + 144 tokens): the card
    (the decoder's self-attention on the kernels) gives the CPU's prefill
    logits within 1e-4 and its greedy tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, build_model
    from repro_torch.serving.engine import Engine
    base = get_config(arch).smoke()
    qover = {} if route == "staged_g1" else dict(granularity=16,
                                                 fused_select_attn=True)
    cfg = dataclasses.replace(base, quoka=dataclasses.replace(base.quoka,
                                                              **qover))
    cpu = build_model(cfg, device="cpu", seed=3)
    gpu = Model(cfg, dev)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(3)
    if arch == "whisper-small":
        batch = {"tokens": rng.integers(3, cfg.vocab, (2, 160)),
                 "frames": rng.standard_normal((2, 64, cfg.d_model))}
    else:
        batch = {"tokens": rng.integers(3, cfg.vocab, (2, 144)),
                 "patches": rng.standard_normal((2, 16, 128))}
    batch = {k: v.astype(np.int32 if k == "tokens" else np.float32)
             for k, v in batch.items()}
    n0 = qs_mod.LAUNCHES
    lg, _ = gpu.prefill(batch, gpu.init_cache(2, 176))
    lc, _ = cpu.prefill(batch, cpu.init_cache(2, 176))
    assert qs_mod.LAUNCHES > n0
    assert _err(lg.cpu(), lc) <= 1e-4
    tg = Engine(gpu).generate(batch, 8).tokens
    tc = Engine(cpu, device="cpu").generate(batch, 8).tokens
    np.testing.assert_array_equal(tg, tc)


TRAIN_ARCHS = ["granite-3-2b", "gemma3-27b", "olmoe-1b-7b",
               "deepseek-v3-671b", "zamba2-7b", "rwkv6-1.6b",
               "whisper-small", "internvl2-1b"]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_matches_cpu(dev, arch, remat):
    """One fp32 training step of each family's smoke config (96 tokens,
    past gemma3's 64-token window), card against CPU from the same
    weights: the loss within 1e-5 relative, every gradient leaf within
    1e-4 of its largest magnitude and the step's gradient norm within
    1e-5 relative (rwkv6 5e-3 for both: the wkv recurrence's fp32
    conditioning, as ``test_torch_train_families.py`` measures it; its
    norm differed by 5.0e-5 relative here); remat on and off.
    Not the weights after the step: Adam's first update is about
    sign(g) * lr, so a near-zero gradient entry may flip it."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import loop
    from repro_torch.training import optimizer as opt
    cfg = dataclasses.replace(get_config(arch).smoke(), remat=remat)
    cpu = build_model(cfg, device="cpu", seed=4)
    gpu = ckpt.from_flat(ckpt.to_flat(cpu), cfg, dev)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 96)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (2, cfg.frontend.n_tokens, cfg.frontend.d_in)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (2, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    ocfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = []
    for model in (cpu, gpu):
        state = loop.init_state(model, None)
        _, grads = loop.value_and_grad(model, batch)
        index = {p: i for i, p in enumerate(model.parameters())}
        flat = ckpt.to_flat(model, lambda p: grads[index[p]])
        _, metrics = loop.make_train_step(model, ocfg)(state, batch)
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                    flat))
    (lc, nc, gc), (lg, ng, gg) = out
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    rwkv = arch == "rwkv6-1.6b"
    assert abs(ng - nc) <= (5e-3 if rwkv else 1e-5) * nc
    tol = 5e-3 if rwkv else 1e-4
    for k, want in gc.items():
        top = max(np.abs(want).max(), 1e-30)
        assert np.abs(gg[k] - want).max() <= tol * top, k


def layer_obs_card_vs_cpu(dev, route, seed=3):
    """The per-layer ``LayerObs`` of a smoke qwen3-4b (fp32, the same
    weights on both devices, reuse interval 2, ``route`` "staged" or
    "fused" at g = 16) from four prefill chunks (the last ragged on row 1)
    and two decode steps, card against CPU.  Raises unless the counts are
    exact on the card and the NaNs lie in the same places, the last decode
    step's layer 1 (a reusing layer) among them; returns (the score
    sketch's max error, calls compared, NaN sketches).  ``chip_smoke.py``
    phase 32 runs this too."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, build_model
    base = get_config("qwen3-4b").smoke()
    qover = {"granularity": 16, "fused_select_attn": True} \
        if route == "fused" else {}
    cfg = dataclasses.replace(base, quoka=dataclasses.replace(
        base.quoka, reuse_interval=2, **qover))
    cpu = build_model(cfg, device="cpu", seed=seed)
    gpu = Model(cfg, dev)
    gpu.load_state_dict(cpu.state_dict())
    t = cfg.quoka.chunk_size
    toks = np.random.default_rng(seed).integers(
        3, cfg.vocab, (2, 4 * t)).astype(np.int32)
    caches = [m.init_cache(2, 6 * t) for m in (cpu, gpu)]
    got = []
    for c in range(4):
        vl = np.array([t, t - 6 if c == 3 else t], np.int32)
        got.append([m.prefill_chunk({"tokens": toks[:, c * t:(c + 1) * t]},
                                    c * t, kc, valid_len=vl,
                                    with_obs=True)[2]
                    for m, kc in zip((cpu, gpu), caches)])
    tok = toks[:, -1]
    for i in range(2):
        res = [m.decode_step(torch.as_tensor(tok, device=m.device).long(),
                             4 * t + i, kc, with_obs=True)
               for m, kc in zip((cpu, gpu), caches)]
        got.append([r[2] for r in res])
        tok = res[0][0].argmax(-1).numpy()
    err, n_nan = 0.0, 0
    for oc, og in got:
        for f in oc._fields:
            a, b = getattr(oc, f), getattr(og, f)
            assert b.device.type == "cuda" and b.dtype == torch.float32
            b = b.cpu()
            assert torch.equal(torch.isnan(a), torch.isnan(b)), (f, a, b)
            ok = ~torch.isnan(a)
            if f.startswith("score_"):
                err = max(err, _err(a[ok], b[ok]) if ok.any() else 0.0)
            else:
                assert torch.equal(a[ok], b[ok]), (f, a, b)
        n_nan += int(torch.isnan(oc.score_lo).sum())
    assert bool(torch.isnan(got[-1][0].score_lo[1]))     # layer 1 reused
    return err, len(got), n_nan


@pytest.mark.parametrize("route", ["staged", "fused"])
def test_layer_obs_on_the_card_match_cpu(dev, route):
    """Card against CPU (``layer_obs_card_vs_cpu``): counts exact, the
    score sketch within 2e-5, NaN in the same places."""
    err, _, _ = layer_obs_card_vs_cpu(dev, route)
    assert err <= 2e-5


def mesh_smoke_case(rank, world, dev):
    """One rank of the tensor-parallel smoke check on the card: smoke
    granite-3-2b (seed 0) at ``model=world``, ranks sharing the card over
    gloo, ``generate`` / ``serve`` / a warm-pool prefix hit against the
    same card's meshless engine (``tests/torch_tp_cases.py``).  Returns
    whether every token array is equal and how many were compared.
    ``chip_smoke.py`` phase 33 runs this too."""
    import torch_tp_cases as cases
    prompts = [np.random.default_rng(3).integers(3, 512, (n,)).astype(
        np.int32) for n in (16, 48, 29)]
    out = cases.serve_case(rank, world, dev, "granite-3-2b", {}, None,
                           prompts)
    pairs = []
    for m in ("full", "quoka"):
        pairs.append((out[f"{m}/generate"], out[f"{m}/generate_mesh"]))
        for key in ("serve_mesh", "serve_hit"):
            pairs += [(out[f"{m}/serve"][i], out[f"{m}/{key}"][i])
                      for i in range(len(prompts))]
    equal = all(np.array_equal(a, b) for a, b in pairs) and \
        out["reassembled"] and out["quoka/cache_hits"] > 0
    return {"equal": bool(equal), "checked": len(pairs),
            "backend": out["backend"]}


def test_mesh_serving_on_the_card(dev):
    """Smoke granite at ``model=2``, two ranks sharing the card over gloo:
    the same tokens as the card's meshless engine on every rank."""
    from repro_torch.launch.mesh import spawn_ranks
    res = spawn_ranks(mesh_smoke_case, 2, device="cuda", timeout=600)
    for r in res:
        assert r["equal"] and r["backend"] == "gloo", r


def test_ep_moe_call_on_the_card_matches_cpu(dev):
    """The expert-parallel MoE call on the card (smoke olmoe, capacity
    factor 0.5) at ``data=2,model=2``, four ranks sharing the card over
    gloo: each rank's two experts on its two rows agree with the meshless
    CPU call within 1e-4 of its largest magnitude, drop the meshless
    run's pairs of those rows (the ranking counts the other data rank's
    rows), and sum the routed partials over ``model`` (``ep``)."""
    import torch_tp_cases as cases
    from repro_torch.launch.mesh import spawn_ranks
    res = spawn_ranks(cases.ep_moe_call_case, 4, "data=2,model=2",
                      device="cuda", timeout=600)
    assert sum(r["drops"] for r in res[::2]) > 0
    for r in res:
        assert r["rel"] <= 1e-4 and r["drops_equal"], r
        assert r["experts"] == 2
        assert r["ep_bytes"].get("all_reduce", 0) > 0, r


def test_mamba_tp_call_on_the_card_matches_cpu(dev):
    """One smoke zamba2 Mamba2 mixer call at ``model=2`` on the card, two
    ranks sharing it over gloo (``torch_tp_cases.mamba_call_case``): each
    rank's 8 of 16 SSD heads, the gated norm's sum of squares and
    ``out_proj``'s partials summed over ``model``, agree with the
    meshless CPU call within 1e-4 of the largest magnitude (output, the
    rank's heads' new state, its convolution tail)."""
    import torch_tp_cases as cases
    from repro_torch.launch.mesh import spawn_ranks
    res = spawn_ranks(cases.mamba_call_case, 2, "model=2", device="cuda",
                      timeout=600)
    for r in res:
        assert max(r["rel"], r["ssd"], r["conv"]) <= 1e-4, r
        assert (r["heads"], r["tail"]) == (8, 256 + 32), r
        assert r["bytes"].get("all_reduce", 0) > 0, r


def test_whisper_tp_call_on_the_card_matches_cpu(dev):
    """One smoke whisper-small prefill (encoder, cross keys and values,
    two ``dec_cross`` layers with QUOKA) and one decode step at
    ``model=2`` on the card, two ranks sharing it over gloo
    (``torch_tp_cases.whisper_call_case``): each rank's 2 of 4 query and
    KV heads, ``wo``, ``xo`` and the MLP's ``down`` summed over
    ``model``, agree with the meshless CPU calls within 1e-4 of the
    largest logit."""
    import torch_tp_cases as cases
    from repro_torch.launch.mesh import spawn_ranks
    res = spawn_ranks(cases.whisper_call_case, 2, "model=2", device="cuda",
                      timeout=600)
    for r in res:
        assert r["rel"] <= 1e-4, r
        assert (r["heads"], r["cross_kv"]) == (2, 2), r
        assert r["bytes"].get("all_reduce", 0) > 0, r


DP_SMOKE_RUNS = (("bf16 b1", "bfloat16", 1, 256),
                 ("fp32 b2", "float32", 2, 128),
                 ("fp32 b1", "float32", 1, 256))


def test_dp_serving_on_the_card(dev):
    """Smoke granite (2 layers) at ``data=2,model=2``, four ranks sharing
    the card over gloo, through phase 34's rank body
    (``torch_tp_cases.dp_card_case``): fp32 tokens at batch 2 (rows over
    ``data``), at batch 1 (the sequence over ``data``, each rank holding
    half the slots) and of a serve with a 256-token prefix hit equal the
    card's meshless run on every rank; bf16 first-step logits within
    0.25 of the meshless logits' largest magnitude; scoring and flash
    launched on every layer call, selected and paged attention never (in
    the serve too); at batch 1 a selecting call moves under a quarter of
    the K cache's bytes, its budget rows no more than one budget."""
    import torch_tp_cases as cases
    from repro_torch.launch.mesh import spawn_ranks
    args = ("granite-3-2b", 2, DP_SMOKE_RUNS, 32, 4)
    ref = cases.dp_card_run(dev, *args, smoke=True)
    ranks = spawn_ranks(cases.dp_card_case, 4, *args, True, device="cuda",
                        timeout=600)
    for r in ranks:
        assert r["backend"] == "gloo"
        for label, dt, b, _ in DP_SMOKE_RUNS:
            got, want = r[label], ref[label]
            n = got["stack_calls"] * 2
            assert got["launches"] == {
                "quoka_score": n, "flash_attention": n,
                "selected_attention": 0, "selected_attention_paged": 0}
            assert got["slots"] * (2 if b == 1 else 1) == got["cap"]
            if b == 1:
                score, rows = cases.dp_moves(got)
                assert 0 < rows <= got["budget_bytes"]
                assert score + rows < got["k_bytes"] / 4
            if dt == "float32":
                assert got["tokens"] == want["tokens"], label
            else:
                drift = float(np.abs(got["logits"] - want["logits"]).max())
                assert drift <= 0.25 * float(np.abs(want["logits"]).max())
        assert r["fp32 serve"]["tokens"] == ref["fp32 serve"]["tokens"]
        assert r["fp32 serve"]["hit_tokens"] == cases.DP_HIT
        sl = r["fp32 serve"]["launches"]
        assert sl["quoka_score"] > 0 and sl["flash_attention"] > 0
        assert sl["selected_attention"] == sl["selected_attention_paged"] \
            == 0


MUTANT_RUNS = (("bf16 g1", "bfloat16", {}),)


def _chip_smoke():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


def _kernel_modules():
    return {"flash": fa_mod, "score": qs_mod, "selected": sa_mod}


def mutant_rank(rank, world, dev, prompt):
    """One rank of phase 33's qwen3-4b bf16 ``generate`` with a wrong head
    mapping: every sharded layer's KV heads reversed, so each query group
    attends another group's keys.  Returns the first-step logits."""
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.models.blocks import AttnBlock
    cs = _chip_smoke()
    qkv = AttnBlock._qkv

    def reversed_kv(self, x, pos, w):
        q, k, v = qkv(self, x, pos, w)
        if self.heads is not None:
            k, v = k.flip(2), v.flip(2)
        return q, k, v

    AttnBlock._qkv = reversed_kv
    mesh = mesh_from_spec(f"model={world}", dev)
    return cs.mesh_run(torch, np, _kernel_modules(), "qwen3-4b", prompt,
                       MUTANT_RUNS, mesh, dev)["bf16 g1"]["logits"]


def test_mesh_bf16_bound_catches_a_wrong_head_mapping(dev):
    """``chip_smoke.py`` phase 33 holds qwen3-4b's bf16 first-step logits
    on a ``model=2`` mesh within ``MESH_BF16_DRIFT`` of their largest
    magnitude; a wrong head mapping must land outside that bound (the
    drift ratio is printed)."""
    from repro_torch.launch.mesh import spawn_ranks
    cs = _chip_smoke()
    prompt = cs.MESH_CASES[0][2]
    ref_logits = cs.mesh_run(torch, np, _kernel_modules(), "qwen3-4b",
                             prompt, MUTANT_RUNS, None, dev)["bf16 g1"][
                                 "logits"]
    torch.cuda.empty_cache()
    scale = float(np.abs(ref_logits).max())
    for logits in spawn_ranks(mutant_rank, 2, prompt, device="cuda",
                              timeout=600):
        ratio = float(np.abs(logits - ref_logits).max()) / scale
        print(f"wrong head mapping: first-step drift {ratio:.4g} x the "
              f"logits' largest magnitude {scale:.4g} (bound "
              f"{cs.MESH_BF16_DRIFT})")
        assert ratio > cs.MESH_BF16_DRIFT


def test_sharded_training_on_the_card_matches_meshless(dev):
    """Smoke granite trained at ``data=2,model=2`` on the card, four ranks
    sharing it over gloo (``torch_train_cases.train_case``, fp32, remat,
    two AdamW steps with clipping that binds): the first rank's loss,
    gradient norms, reassembled gradients and updates equal the card's
    meshless run of the same steps (``torch_train_cases.check``: 1e-5,
    1e-4 of each leaf's largest magnitude, 1e-3 in L2), and no kernel is
    launched (the training forward is plain attention)."""
    import torch_train_cases as tc
    from repro_torch.launch.mesh import spawn_ranks
    cfgkw = dict(arch="granite-3-2b", remat=True)
    batches = tc.train_batches(tc.train_cfg(**cfgkw), 4, 64, seed=0)
    res = spawn_ranks(tc.train_world, 4,
                      [("granite", ("data=2,model=2", cfgkw, None, batches,
                                    0.05), dict(meshless=True))],
                      device="cuda", timeout=600)
    r0 = res[0]["granite"]
    tc.check(r0["cmp"], what="smoke granite data=2,model=2 on the card")
    assert r0["steps"][0][1] > 0.05
    for r in res:
        assert not any(r["granite"]["launches"].values())


def test_row_partial_backward_on_the_card(dev):
    """A row-parallel layer's bf16 partial product (one GEMM with an fp32
    result, ``layers.row_partial``) differentiates on the card: its
    product and gradients within bf16 rounding of the fp32 product's."""
    import torch_train_cases as tc
    errs = tc.row_partial_grad_errors(dev)
    assert max(errs.values()) <= 2e-2, errs
