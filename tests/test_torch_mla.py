"""The port's MLA block (``repro_torch/models/blocks.py::MLABlock``) and its
latent cache against the JAX reference's, at deepseek-v3's smoke geometry,
fp32 on the CPU.

The reference block's initial parameters are carried into the port's
block; activations come from numpy with a seed.  Four chunks run through
both blocks against one cache each (capacity 80 > budget 32 + chunk 16,
so every QUOKA chunk selects): each chunk's output and the cache (latent,
rope key, positions) agree within 2e-5 (fp32, only summation order
differs).  The port's absorbed attention also equals the explicit
decompressed form, mirroring the reference's own test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.blocks import MLABlock as RefMLA
from repro.serving.cache import BlockCache
from repro.serving.cache import latent_init as ref_latent_init
from repro.serving.cache import latent_write as ref_latent_write
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config as port_config
from repro_torch.core.attention import dense_attention, position_mask
from repro_torch.models.blocks import MLABlock
from repro_torch.models.layers import linear, rmsnorm, rope
from repro_torch.serving.cache import latent_init, latent_write
from repro_torch.training.checkpoint import _block_leaves

torch.set_num_threads(2)

TOL = 2e-5
KEY = jax.random.PRNGKey(0)
CAP, CHUNK = 80, 16


def _pair(kind, qover=None):
    rc = ref_config("deepseek-v3-671b").smoke()
    pc = port_config("deepseek-v3-671b").smoke()
    if qover:
        rc = dataclasses.replace(rc, quoka=dataclasses.replace(rc.quoka,
                                                               **qover))
        pc = dataclasses.replace(pc, quoka=dataclasses.replace(pc.quoka,
                                                               **qover))
    rblk = RefMLA(rc, kind)
    p = rblk.init(KEY)
    blk = MLABlock(pc, "cpu", kind)
    leaves = _block_leaves(blk)
    with torch.no_grad():
        for key, arr in _flatten(p).items():
            leaves[key].copy_(torch.from_numpy(np.array(arr)))
    return rc, rblk, p, pc, blk


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["mla", "mla_moe"])
@pytest.mark.parametrize("method,qover", [
    ("full", None), ("quoka", None),
    ("quoka", {"granularity": 16, "fused_select_attn": True})])
def test_mla_block_chunks_and_cache_match_reference(kind, method, qover):
    """Chunk outputs and the latent cache after every chunk; batch row 1
    has four pad slots (pos -1) in its first chunk.  Fused selection still
    runs the staged route for MLA, as the reference's ``fused_route``."""
    rc, rblk, p, pc, blk = _pair(kind, qover)
    rng = np.random.default_rng(1)
    b = 2
    rcache = BlockCache(latent=ref_latent_init(
        b, CAP, rc.mla.kv_lora_rank, rc.mla.qk_rope_dim, jnp.float32))
    lat = blk.init_cache(b, CAP)
    for c in range(4):
        x = rng.standard_normal((b, CHUNK, rc.d_model), np.float32) * 0.5
        pos = np.arange(c * CHUNK, (c + 1) * CHUNK, dtype=np.int32)[None] \
            .repeat(b, 0)
        if c == 0:
            pos[1, :4] = -1
        rctx = {"method": method, "qcfg": rc.quoka, "slot": c * CHUNK,
                "backend": "xla"}
        want, rcache, _, _ = rblk.apply(p, jnp.asarray(x), jnp.asarray(pos),
                                        rcache, rctx)
        got, _ = blk.apply(torch.as_tensor(x), torch.as_tensor(pos), lat,
                           {"method": method, "qcfg": pc.quoka,
                            "slot": c * CHUNK})
        _close(got, want)
        _close(lat.ckv, rcache.latent.ckv)
        _close(lat.krope, rcache.latent.krope)
        np.testing.assert_array_equal(lat.pos.numpy(),
                                      np.asarray(rcache.latent.pos))


def test_mla_decode_step_matches_reference():
    """A decode step (t = 1) at per-row positions after a two-chunk
    prefill, through the selecting route."""
    rc, rblk, p, pc, blk = _pair("mla")
    rng = np.random.default_rng(2)
    b = 2
    rcache = BlockCache(latent=ref_latent_init(
        b, CAP, rc.mla.kv_lora_rank, rc.mla.qk_rope_dim, jnp.float32))
    lat = blk.init_cache(b, CAP)
    steps = [(np.arange(32, dtype=np.int32)[None].repeat(b, 0), 0),
             (np.array([[32], [33]], np.int32), np.array([32, 33]))]
    for pos, slot in steps:
        x = rng.standard_normal((b, pos.shape[1], rc.d_model),
                                np.float32) * 0.5
        rslot = slot if np.ndim(slot) == 0 else jnp.asarray(slot, jnp.int32)
        pslot = slot if np.ndim(slot) == 0 else torch.as_tensor(slot)
        want, rcache, _, _ = rblk.apply(
            p, jnp.asarray(x), jnp.asarray(pos), rcache,
            {"method": "quoka", "qcfg": rc.quoka, "slot": rslot,
             "backend": "xla"})
        got, _ = blk.apply(torch.as_tensor(x), torch.as_tensor(pos), lat,
                           {"method": "quoka", "qcfg": pc.quoka,
                            "slot": pslot})
        _close(got, want)
    _close(lat.latent[..., :rc.mla.kv_lora_rank], rcache.latent.ckv)


@pytest.mark.parametrize("per_row", [False, True])
def test_latent_write_matches_reference(per_row):
    """Scalar and per-row starts, explicit positions with pad slots; the
    latent and rope key are views of one buffer."""
    rng = np.random.default_rng(3)
    b, cap, r, rd, t = 3, 24, 8, 4, 5
    ckv = rng.standard_normal((b, t, r), np.float32)
    kr = rng.standard_normal((b, t, rd), np.float32)
    pos = rng.integers(-1, 50, (b, t)).astype(np.int32)
    start = np.array([0, 7, 19], np.int32) if per_row else 9
    want = ref_latent_write(ref_latent_init(b, cap, r, rd, jnp.float32),
                            jnp.asarray(ckv), jnp.asarray(kr),
                            jnp.asarray(start), pos_new=jnp.asarray(pos))
    lat = latent_init(b, cap, r, rd, torch.float32, "cpu")
    got = latent_write(lat, torch.as_tensor(ckv), torch.as_tensor(kr),
                       torch.as_tensor(start) if per_row else start,
                       pos_new=torch.as_tensor(pos))
    assert got.latent.data_ptr() == lat.ckv.data_ptr()
    _close(got.ckv, want.ckv)
    _close(got.krope, want.krope)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))


def test_absorbed_attention_equals_explicit_decompressed():
    """Attention in latent space (queries absorbed through W_uk, values
    decompressed by W_uv after the softmax) equals standard attention over
    explicitly decompressed per-head keys and values."""
    _, _, _, pc, blk = _pair("mla")
    m, b, t = pc.mla, 2, 32
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (b, t, pc.d_model), np.float32) * 0.1)
    pos = torch.arange(t, dtype=torch.int32)[None].repeat(b, 1)
    h = rmsnorm(blk.ln1, x, pc.norm_eps)
    q_abs, q_rope = blk._queries(h, pos)
    ckv, kr = blk._latent_kv(h, pos)
    mask = position_mask(pos, pos, causal=True)
    got = blk._absorbed_attention(q_abs, q_rope, ckv, kr, mask)
    k_nope = torch.einsum("btr,rhn->bthn", ckv, blk.wk_b)
    v_full = torch.einsum("btr,rhv->bthv", ckv, blk.wv_b)
    cq = rmsnorm(blk.q_ln, linear(blk.wq_a, h), pc.norm_eps)
    q = linear(blk.wq_b, cq).reshape(b, t, pc.n_heads,
                                     m.qk_nope_dim + m.qk_rope_dim)
    q_full = torch.cat([q[..., :m.qk_nope_dim],
                        rope(q[..., m.qk_nope_dim:], pos, pc.rope_theta)],
                       dim=-1)
    k_full = torch.cat([k_nope, kr[:, :, None, :].expand(
        b, t, pc.n_heads, m.qk_rope_dim)], dim=-1)
    want = dense_attention(q_full, k_full, v_full, mask, scale=blk.scale)
    np.testing.assert_allclose(got.numpy(), want.reshape(b, t, -1).numpy(),
                               atol=2e-4, rtol=2e-4)
