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


@pytest.mark.parametrize("dv", [576, 512])
@pytest.mark.parametrize("tq", [16, 1])
def test_flash_plain_at_mla_width_matches_reference(tq, dv):
    """MLA's flash call at d = 576 (one latent KV head, 8 query heads,
    scale 1/sqrt(192), the first 64 keys a selected budget): V 576 wide,
    or the 512-wide latent, whose output must equal the reference's call
    on V zero-padded to 576 sliced to 512 columns (``blocks.py``'s
    ``[..., :r]``), against the xla oracle and the interpret-mode Pallas
    kernel.  Key 3 is invalid everywhere."""
    rng = np.random.default_rng(tq + dv)
    tk, boundary, scale = 80, 64, 192 ** -0.5
    q = rng.standard_normal((1, 8, tq, 576), np.float32)
    k = rng.standard_normal((1, 1, tk, 576), np.float32)
    v = k[..., :dv] if dv == 512 else \
        rng.standard_normal((1, 1, tk, 576), np.float32)
    v_ref = np.pad(v, ((0, 0),) * 3 + ((0, 576 - dv),))
    valid = rng.random((1, tk)) < 0.9
    valid[:, 3] = False
    (jq, tq_), (jk, tk_), (jv, _), (jval, tval) = map(
        _both, (q, k, v_ref, valid))
    got = flash_attention_bhtd(tq_, tk_, torch.as_tensor(np.ascontiguousarray(
        v)), tval, causal=True, boundary=boundary, scale=scale)
    assert got.shape == (1, 8, tq, dv)
    kw = dict(causal=True, boundary=boundary, scale=scale)
    _close(got, ref_ref.flash_attention_ref(jq, jk, jv, k_valid=jval,
                                            **kw)[..., :dv])
    _close(got, ref_flash(jq, jk, jv, jval, block_q=16, block_k=32,
                          **kw)[..., :dv])


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
    (1, 1, 16, 300, 576),     # MLA-latent-like single-kv-head
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


@pytest.mark.parametrize("d", [8, 24, 40, 56, 72, 88, 104, 112, 120])
def test_score_plain_at_widths_off_the_16_grid_matches_reference(d):
    """Head dims the scoring kernel stages at the next multiple of 16
    (h2o-danube's 120 among them), over a wrapped ring's validity (the
    chunk's own slots mid-ring invalid, one row with no valid slot): the
    plain version equals the reference's xla oracle and its interpret-mode
    Pallas kernel within 2e-5."""
    b, nkv, nq, t = 2, 2, 16, 256
    rng = np.random.default_rng(d)
    qb = rng.standard_normal((b, nq, nkv, d), np.float32)
    qb /= np.linalg.norm(qb, axis=-1, keepdims=True)
    k = rng.standard_normal((b, t, nkv, d), np.float32)
    last = 200 + 15                      # a 16-token chunk at 200, mid-ring
    pos = last - (last - np.arange(t)) % t
    valid = np.broadcast_to((pos >= 0) & (pos < 200), (b, t)).copy()
    valid[1] = False
    (jqb, tqb), (jk, tk_), (jval, tval) = map(_both, (qb, k, valid))
    got = ops.score(tqb, tk_, tval)
    _close(got, ref_ops._score_xla(jqb, jk, jval))
    _close(got, ref_score(jqb.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                          jval, block_t=128))
    assert bool((got[1] == -1e30).all())


@pytest.mark.parametrize("d", [24, 120])
def test_score_zero_columns_leave_scores_unchanged(d):
    """The kernel's staging of d = 120 at 128: zero columns appended to q̄
    and K change neither a product nor a key's norm, so the plain
    version's scores at the staged width equal those at d within 1e-6
    (the extra terms are exact zeros; only fp32 summation over another
    length differs)."""
    from repro_torch.kernels import tiling
    dp = tiling.score_width(d)
    assert dp == -(-d // 16) * 16 and dp > d
    rng = np.random.default_rng(d + 1)
    qb = torch.as_tensor(rng.standard_normal((1, 4, 3, d), np.float32))
    qb = qb / qb.norm(dim=-1, keepdim=True)
    k = torch.as_tensor(rng.standard_normal((1, 100, 3, d), np.float32))
    valid = torch.as_tensor(rng.random((1, 100)) < 0.7)
    pad = torch.nn.functional.pad
    np.testing.assert_allclose(
        ops.score(pad(qb, (0, dp - d)), pad(k, (0, dp - d)), valid).numpy(),
        ops.score(qb, k, valid).numpy(), atol=1e-6, rtol=0)


def test_score_plain_rounds_qbar_to_key_dtype():
    """bf16 keys with an fp32 q̄ (the main path's types): the plain version
    rounds q̄ to bf16 before the products, as the reference's production
    oracle does (the CUDA kernel now does the rounding itself, so the
    wrapper no longer casts); without the rounding the scores would move
    by far more than the tolerance."""
    b, nkv, nq, t, d = 2, 2, 5, 100, 80
    rng = np.random.default_rng(4)
    qb = rng.standard_normal((b, nq, nkv, d), np.float32)
    qb /= np.linalg.norm(qb, axis=-1, keepdims=True)
    k = torch.as_tensor(rng.standard_normal((b, t, nkv, d), np.float32))
    k = k.to(torch.bfloat16)
    valid = rng.random((b, t)) < 0.8
    (jqb, tqb), (jval, tval) = _both(qb), _both(valid)
    jk = jnp.asarray(k.float().numpy()).astype(jnp.bfloat16)
    got = ops.score(tqb, k, tval)
    assert got.dtype == torch.float32
    _close(got, ref_ops._score_xla(jqb, jk, jval))
    _close(got, ref_score(jqb.astype(jnp.bfloat16).transpose(0, 2, 1, 3),
                          jk.transpose(0, 2, 1, 3), jval, block_t=128))
    unrounded = ops.score(tqb, k.float(), tval)
    assert float((unrounded - got)[tval[:, None].expand_as(got)].abs()
                 .max()) > 10 * TOL


def _fused_case(case, d=16):
    """(q, k, v, key_pos, idx, start, g) as numpy, one geometry tuple of
    the reference's FUSED_CASES (plan ids include -1 padding and, at
    g == 1, slots at or past the chunk start), at head dim ``d``."""
    g, b, h, n_kv, T, chunk, start, nsel, seed = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, chunk, h, d), np.float32)
    k = rng.standard_normal((b, T, n_kv, d), np.float32)
    v = rng.standard_normal((b, T, n_kv, d), np.float32)
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


@pytest.mark.parametrize("d", [8, 32, 80])
@pytest.mark.parametrize("case", [FUSED_CASES[0], FUSED_CASES[3]])
def test_selected_plain_at_head_dims_matches_reference(case, d):
    """Selected attention at the head dims the attention tiles gained
    (d = 8 and 80 are padded to 16 and 80's rows keep a tail of
    unswizzled chunks on the card), g = 16 and g = 1, against the
    reference's oracle and its interpret-mode Pallas kernel."""
    q, k, v, key_pos, idx, start, g = _fused_case(case, d)
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


# launch geometry of the bf16 attention tile (csrc/attn_mma.cuh): pure
# Python, so it is checked here; the kernels themselves run on the card
N_SM = 132          # H100 SXM
MAIN_GEOMETRIES = [
    # (b, n_kv, group, tq, n_keys): qwen3-4b flash / selected / serve
    (1, 8, 4, 128, 1152), (1, 8, 4, 1, 1025),
    (1, 8, 4, 128, 64 * 16 + 128), (1, 8, 4, 1, 64 * 16 + 1),
    (4, 8, 4, 128, 64 * 16 + 128), (4, 8, 4, 1, 64 * 16 + 1),
]
SMALL_GEOMETRIES = [(b, n_kv, group, tq, n_keys)
                    for b in (1, 4) for n_kv in (1, 2, 8)
                    for group in (1, 2, 4, 8) for tq in (1, 16, 37, 128)
                    for n_keys in (1, 64, 65, 1025, 4224)]


@pytest.mark.parametrize("shape", MAIN_GEOMETRIES + SMALL_GEOMETRIES[::7])
def test_attn_geometry_covers_rows_and_keys(shape):
    from repro_torch.kernels import tiling
    b, n_kv, group, tq, n_keys = shape
    m_tiles, n_split = tiling.attn_geometry(b, n_kv, group, tq, n_keys, N_SM)
    # every (head, row) pair of the group in exactly one M tile, head-major
    seen = [(p // tq, p % tq) for mt in range(m_tiles)
            for p in range(mt * tiling.BM, (mt + 1) * tiling.BM)
            if p < group * tq]
    assert sorted(seen) == [(hg, i) for hg in range(group)
                            for i in range(tq)]
    assert m_tiles * tiling.BM - group * tq < tiling.BM
    # slices [s * n // S, (s + 1) * n // S) cover the key tiles, none empty
    n_tiles = max(1, -(-n_keys // tiling.BN))
    assert 1 <= n_split <= n_tiles
    bounds = [s * n_tiles // n_split for s in range(n_split + 1)]
    assert bounds[0] == 0 and bounds[-1] == n_tiles
    assert all(hi - lo >= 1 for lo, hi in zip(bounds, bounds[1:]))
    # the card is filled, within one wave of resident blocks, where the
    # key walk allows it
    blocks = b * n_kv * m_tiles
    if blocks >= N_SM:
        assert n_split == 1
    else:
        assert blocks * n_split >= N_SM or n_split == n_tiles
        assert blocks * n_split <= tiling.BLOCKS_PER_SM * N_SM


@pytest.mark.parametrize("g,t,nsel", [(16, 128, 64), (16, 1, 64),
                                      (1, 128, 1024), (1, 1, 1024)])
def test_linear_and_paged_split_alike(monkeypatch, g, t, nsel):
    """The linear and the paged wrapper derive the same launch geometry
    for one shape (phase 9 of chip_smoke.py holds them bitwise equal)."""
    from repro_torch.kernels import selected_attention as sa
    from repro_torch.kernels import tiling
    monkeypatch.setattr(tiling, "sm_count", lambda index: N_SM)
    b, h, n_kv, d = 4, 32, 8, 128
    q = torch.zeros((b, h, t, d), dtype=torch.bfloat16)
    ids = torch.full((b, n_kv, nsel) if g == 1 else (b, nsel), -1)
    got = []
    for view in ("linear", "paged"):
        idx, _, _ = sa._plan_inputs(q, ids, 0, g, n_kv, view)
        geom, scratch = sa._split_args(q, idx, g, n_kv)
        got.append((geom[0], [tuple(x.shape) for x in scratch]))
    assert got[0] == got[1]
    n_split, shapes = got[0]
    m_tiles, want = tiling.attn_geometry(b, n_kv, h // n_kv, t,
                                         nsel * g + t, N_SM)
    assert n_split == want
    rows = b * n_kv * m_tiles * tiling.BM
    assert shapes == ([] if n_split == 1 else
                      [(n_split, rows, d), (n_split, rows, 2)])
    assert (n_split > 1) == (t == 1)       # decode splits, prefill fills


def test_tile_shape_reaches_the_compiler():
    """The bf16 tile's BM, BN and resident blocks are defined once, in
    tiling.py: build.py hands them to nvcc and attn_mma.cuh takes its
    constants from those macros (it refuses to build without them)."""
    from repro_torch.kernels import build, tiling
    assert set(tiling.NVCC_DEFINES) <= set(build.NVCC_FLAGS)
    header = (build.CSRC / "attn_mma.cuh").read_text()
    for flag, name in zip(tiling.NVCC_DEFINES,
                          ("BM", "BN", "BLOCKS_PER_SM")):
        macro = flag[2:].split("=")[0]
        assert f"constexpr int {name} = {macro};" in header
        assert f"defined({macro})" in header
    # the d <= 128 tile is built with BLOCKS_PER_SM as its launch bound
    assert "__launch_bounds__(NTHREADS, C::BLOCKS)" in header
    assert "using Cfg = Tile<D, D, BN, BLOCKS_PER_SM>;" in header
    for name in ("WIDE_D", "WIDE_DV", "WIDE_BN"):
        macro = f"QUOKA_{name}"
        assert f"-D{macro}={getattr(tiling, name)}" in tiling.NVCC_DEFINES
        assert f"constexpr int {name} = {macro};" in header
        assert f"defined({macro})" in header
    assert "using Wide = Tile<WIDE_D, WIDE_DV, WIDE_BN, 1>;" in header
    assert tiling.WIDE_BLOCKS_PER_SM == 1


def test_attention_tiles_take_every_head_dim_to_128():
    """The attention tiles build each head dim that is a multiple of 8 up
    to 128 at the next multiple of 16 (the mma's k), and refuse any other
    before a launch; at every width the bf16 tile's ring fits one block's
    shared memory and BLOCKS_PER_SM blocks of it fit an SM (3 stages where
    they fit, as at d = 64, else 2, as at d = 128); the header's layout is
    the one ``attn_smem`` mirrors and its stage rule reads the same
    compiler constants."""
    from repro_torch.kernels import build, tiling
    widths = {d: tiling.attn_width("k", d) for d in range(8, 129, 8)}
    assert all(w % 16 == 0 and w - 16 < d <= w for d, w in widths.items())
    assert sorted(set(widths.values())) == list(range(16, 129, 16))
    for d in (0, 4, 12, 100, 136, 576):
        with pytest.raises(ValueError, match="head dim"):
            tiling.attn_width("k", d)
    for w in range(16, 129, 16):
        st = tiling.attn_stages(w)
        smem = tiling.attn_smem(w, st)
        assert st in (2, 3) and smem <= tiling.SMEM_PER_BLOCK
        assert tiling.BLOCKS_PER_SM * (smem + 1024) <= tiling.SMEM_PER_SM
    assert (tiling.attn_stages(64), tiling.attn_stages(128)) == (3, 2)
    header = (build.CSRC / "attn_mma.cuh").read_text()
    assert "BM * DK * 2 + stages * TBN * (DK + DV) * 2 +\n" \
        "         (stages + 1) * (TBN * 24 + 4)" in header
    assert "NB * (attn_smem<DK, DV, TBN>(3) + 1024) <= SMEM_PER_SM ? 3 : 2" \
        in header
    assert "using Cfg = Tile<D, D, BN, BLOCKS_PER_SM>;" in header
    for flag in (f"-DQUOKA_SMEM_PER_SM={tiling.SMEM_PER_SM}",
                 f"-DQUOKA_SMEM_PER_BLOCK={tiling.SMEM_PER_BLOCK}"):
        assert flag in build.NVCC_FLAGS


def test_flash_wide_tile_geometry():
    """Flash takes every multiple of 8 up to 128 and MLA's 576 (the wide
    tile), no width between, and V up to the key width; the wide tile's
    Q and 3-stage ring of 32-key K tiles and 128-column V slices fit one
    block's shared memory; deepseek-v3's prefill fills the card with 4
    column slices of 256 row tiles, its decode (2 row tiles) splits the
    key walk 16 ways."""
    from repro_torch.kernels import tiling
    assert tiling.flash_width(80, 80) == 80
    assert tiling.flash_width(576, 512) == tiling.flash_width(576, 8) == 576
    for d, dv in ((584, 8), (572, 8), (136, 8), (256, 128), (64, 72),
                  (576, 12), (576, 0)):
        with pytest.raises(ValueError, match="head dim|value width"):
            tiling.flash_width(d, dv)
    args = (tiling.WIDE_D, 3, tiling.WIDE_DV, tiling.WIDE_BN)
    assert tiling.attn_stages(tiling.WIDE_D, tiling.WIDE_DV, tiling.WIDE_BN,
                              tiling.WIDE_BLOCKS_PER_SM) == 3
    assert tiling.attn_smem(*args) + 1024 <= tiling.SMEM_PER_BLOCK
    assert tiling.wide_geometry(1, 1, 128, 128, 1152, 512, N_SM) == \
        (256, 4, 1)
    assert tiling.wide_geometry(1, 1, 128, 1, 1025, 512, N_SM) == (2, 4, 16)
    assert tiling.wide_geometry(1, 1, 128, 1, 1025, 576, N_SM)[1] == 5


def test_bf16_rows_must_be_16_byte_aligned():
    """The bf16 tile copies 16-byte chunks: a view whose rows start off a
    16-byte boundary is refused before any launch; fp32 (the simple tile)
    and aligned views pass."""
    from repro_torch.kernels import tiling
    x = torch.zeros((1, 2, 8, 72), dtype=torch.bfloat16)
    tiling.check_aligned("k", ok=x[..., :64], f32=x.float()[..., 1:65])
    with pytest.raises(ValueError, match="16-byte aligned"):
        tiling.check_aligned("k", q=x[..., 4:68])


# launch geometry of the scoring kernel (csrc/quoka_score.cu)
SCORE_GEOMETRIES = [
    # (b, n_kv, n_q, T, d, bytes per K element)
    (1, 8, 16, 8224, 128, 2), (1, 8, 1, 8224, 128, 2),   # qwen3-4b
    (4, 8, 16, 8320, 128, 2), (4, 8, 1, 8320, 128, 2),   # serve step
    (1, 1, 16, 300, 576, 2), (1, 1, 16, 300, 576, 4),    # MLA latent
    (2, 2, 5, 100, 80, 2), (2, 2, 5, 100, 80, 4),
    (1, 8, 16, 4096, 120, 2), (1, 8, 1, 4096, 120, 2),   # h2o-danube ring
    (1, 16, 16, 8224, 128, 2),                            # gemma3 global
    (1, 8, 20, 1000, 64, 4), (2, 4, 16, 512, 64, 4), (1, 8, 1, 17, 16, 2),
    (64, 32, 16, 65536, 128, 2),                          # more blocks than SMs
]


@pytest.mark.parametrize("shape", SCORE_GEOMETRIES)
def test_score_geometry_covers_every_tile(shape):
    """Blocks c = 0 .. n_chunks - 1 of a (batch, KV head) walk tiles c,
    c + n_chunks, ... (the kernel's loop): every tile exactly once; the
    padded query blocks of 16 cover n_q; the ring fits one block's shared
    memory; the card is filled where the tiles allow."""
    from repro_torch.kernels import tiling
    b, n_kv, n_q, T, d, elem = shape
    g = tiling.score_geometry(b, n_kv, n_q, T, d, elem, N_SM)
    n_tiles = -(-T // (g.warps * tiling.SCORE_KEYS))
    assert 1 <= g.n_chunks <= n_tiles
    walked = [c + j * g.n_chunks for c in range(g.n_chunks)
              for j in range((n_tiles - 1 - c) // g.n_chunks + 1)]
    assert sorted(walked) == list(range(n_tiles))
    assert g.nq_pad % 16 == 0 and g.nq_pad - 16 < n_q <= g.nq_pad
    assert g.stages in (2, 3) and 1 <= g.warps <= tiling.SCORE_WARPS
    assert g.smem == tiling.score_smem(d, elem, g.nq_pad, g.warps, g.stages)
    assert g.smem <= tiling.SMEM_PER_BLOCK
    blocks = b * n_kv * g.n_chunks
    assert blocks >= N_SM or g.n_chunks == n_tiles
    if d <= 128 and elem == 2:     # the main path's tile: 64 keys, 3 stages
        assert (g.warps, g.stages) == (tiling.SCORE_WARPS, 3)


@pytest.mark.parametrize("elem", [2, 4])
def test_score_ring_fits_every_head_dim(elem):
    """Every head dim the kernel takes (multiples of 8 up to 576, MLA's
    latent; one off the 16-grid staged at the next multiple of 16, with
    that width's geometry) gets a ring of at least two stages within one
    block's shared memory; other head dims are refused before any
    launch."""
    from repro_torch.kernels import tiling
    for d in range(8, tiling.SCORE_MAX_D + 1, 8):
        for n_q in (1, 5, 16, 20):
            g = tiling.score_geometry(1, 8, n_q, 8224, d, elem, N_SM)
            assert g.stages >= 2 and g.smem <= tiling.SMEM_PER_BLOCK
            assert g == tiling.score_geometry(1, 8, n_q, 8224,
                                              -(-d // 16) * 16, elem, N_SM)
    for d in (0, 4, 12, 100, 580, 592, 1024):
        with pytest.raises(ValueError, match="head dim"):
            tiling.score_geometry(1, 8, 16, 8224, d, elem, N_SM)


def test_score_tile_reaches_the_compiler():
    """The scoring block's warp count is defined in tiling.py only:
    build.py hands it to nvcc and quoka_score.cu takes its launch bound
    from the macro (it refuses to build without it)."""
    from repro_torch.kernels import build, tiling
    flag = f"-DQUOKA_SCORE_WARPS={tiling.SCORE_WARPS}"
    assert flag in tiling.NVCC_DEFINES and flag in build.NVCC_FLAGS
    src = (build.CSRC / "quoka_score.cu").read_text()
    assert "constexpr int MAX_WARPS = QUOKA_SCORE_WARPS;" in src
    assert "defined(QUOKA_SCORE_WARPS)" in src
    assert "__launch_bounds__(MAX_WARPS * 32)" in src
    assert "ptx.cuh" in build.HEADERS
