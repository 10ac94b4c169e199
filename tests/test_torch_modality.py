"""The modality families in the port against the JAX reference at smoke
size, on the CPU: whisper-small (an encoder over stub frame embeddings,
decoder layers of causal self-attention, cross-attention and an MLP, all
with LayerNorm; QUOKA selects on the decoder's self-attention) and
internvl2-1b (a projector of stub patch embeddings ahead of a GQA
decoder).

Both packages run the same weights through the weight bridge; inputs are
drawn with numpy from a seed.  Checked: ``_act("gelu")`` equals
``jax.nn.gelu`` (the tanh form) and ``layernorm`` the reference's within
1e-6; an ``enc_attn`` block's full-sequence pass, a ``dec_cross`` block
chunk by chunk (under ``full``, staged ``quoka`` and fused ``quoka`` at
g = 16), ``Model.encode``, ``_build_cross`` and the VLM's
``embed_inputs`` within 1e-4 of the reference's; prefill and decode
logits within 1e-4 and the greedy tokens of ``generate`` equal to the
reference's for both models under the three routes; selection (scoring
and attention calls) on the decoder's self-attention only; chunkwise
prefill equal to the monolithic one; the VLM's refusal of padding, with
the reference's message; a model's refusal of an encoder or a frontend
its family would not read.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import layers as ref_layers
from repro.models.model import build_model as ref_build
from repro.serving.engine import Engine as RefEngine
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config as port_config
from repro_torch.models import layers
from repro_torch.serving.engine import Engine
from repro_torch.training.checkpoint import from_flat

torch.set_num_threads(2)

LOGIT_TOL = 1e-4
# whisper: 96 decoder tokens; internvl2: 16 patches + 80 tokens = 96
# positions; 96 > budget 32 + chunk 16, so every chunk selects
POSITIONS, MAX_NEW, BATCH = 96, 8, 2
ARCHS = ("whisper-small", "internvl2-1b")
VARIANTS = {
    "full": ("full", {}),
    "quoka_staged": ("quoka", {}),
    "quoka_g16_fused": ("quoka", {"granularity": 16,
                                  "fused_select_attn": True}),
}
CASES = [(a, v) for a in ARCHS for v in sorted(VARIANTS)]


def _pair(arch, qover=None):
    """(reference model, its params, the port's model with those weights)."""
    qover = qover or {}
    rc = ref_config(arch).smoke()
    rc = dataclasses.replace(rc, quoka=dataclasses.replace(rc.quoka, **qover))
    pc = port_config(arch).smoke()
    pc = dataclasses.replace(pc, quoka=dataclasses.replace(pc.quoka, **qover))
    rm = ref_build(rc)
    params = rm.init(jax.random.PRNGKey(0))
    return rm, params, from_flat(_flatten(params), pc, "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _batch(cfg, seed):
    """A prompt of ``POSITIONS`` positions as numpy arrays: tokens, and
    whisper's frames (b, n_ctx, d) or the VLM's patches (b, n, d_in),
    which take ``n`` of the positions."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(
        3, cfg.vocab, (BATCH, POSITIONS - cfg.prefix_positions)
    ).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = _x((BATCH, cfg.encoder.n_ctx, cfg.d_model),
                             seed + 1)
    else:
        batch["patches"] = _x((BATCH, cfg.frontend.n_tokens,
                               cfg.frontend.d_in), seed + 1)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_gelu_is_the_tanh_form_of_jax():
    """``_act("gelu")`` equals ``jax.nn.gelu`` (whose default is the tanh
    approximation) within 1e-6 in fp32; the exact erf form is up to 4.7e-4
    away on [-4, 4]."""
    x = np.concatenate([np.linspace(-4, 4, 101),
                        _x((1000,), 0) * 3]).astype(np.float32)
    got = layers._act("gelu", _t(x))
    want = jax.nn.gelu(jnp.asarray(x))
    _close(got, want, 1e-6)
    erf = torch.nn.functional.gelu(_t(x))
    assert float((erf - _t(np.asarray(want))).abs().max()) > 1e-4


def test_layernorm_matches_reference():
    """fp32 and bf16 inputs: fp32 statistics, gain and bias, cast back."""
    x = _x((3, 7, 96), 1) * 2 + 0.5
    g, b = _x((96,), 2), _x((96,), 3)
    want = ref_layers.layernorm({"g": jnp.asarray(g), "b": jnp.asarray(b)},
                                jnp.asarray(x))
    _close(layers.layernorm(_t(g), _t(b), _t(x)), want, 1e-6)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    got = layers.layernorm(_t(g), _t(b), xb)
    want = ref_layers.layernorm({"g": jnp.asarray(g), "b": jnp.asarray(b)},
                                jnp.asarray(xb.float().numpy(), jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _row(tree, r=0):
    return jax.tree.map(lambda a: a[r], tree)


def test_enc_attn_block_full_forward_matches_reference():
    """Encoder layer 1 on 64 frames: bidirectional attention (a later
    frame changes an earlier output) and the gelu MLP, LayerNorms with
    bias, within 1e-4 of the reference's ``train``."""
    rm, params, pm = _pair("whisper-small")
    blk, rblk = pm.enc.layers[1], rm.enc_stack.blocks[0]
    x = _x((BATCH, 64, pm.cfg.d_model), 4)
    pos = np.tile(np.arange(64, dtype=np.int32), (BATCH, 1))
    want, _ = rblk.train(_row(params["enc"]["stack"][0], 1), jnp.asarray(x),
                         jnp.asarray(pos), {})
    got = blk.full_forward(_t(x), _t(pos))
    _close(got, want)
    x2 = x.copy()
    x2[:, -1] = _x(x2[:, -1].shape, 5) * 30
    assert float((blk.full_forward(_t(x2), _t(pos))[:, 0]
                  - got[:, 0]).abs().max()) > 1e-3


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dec_cross_block_matches_reference(variant):
    """Decoder layer 0 over six 16-token chunks into a 96-slot cache with
    the cross-attention keys of a random encoder output: every chunk's
    output within 1e-4 of the reference's ``apply``, the self-attention's
    cache positions equal; every chunk selects (cap 96 > budget 32 + chunk
    16)."""
    method, qover = VARIANTS[variant]
    rm, params, pm = _pair("whisper-small", qover)
    cfg, rcfg = pm.cfg, rm.cfg
    blk = pm.stacks[0].layers[0]
    rblk = rm.stacks[0].blocks[0]
    rp = _row(params["stacks"][0][0])
    enc_out = _x((BATCH, cfg.encoder.n_ctx, cfg.d_model), 5)
    cache = blk.init_cache(BATCH, POSITIONS)
    cross = blk.build_cross(_t(enc_out))
    cache.cross.k.copy_(cross.k)
    cache.cross.v.copy_(cross.v)
    rcache = rblk.cache_spec(BATCH, POSITIONS, jnp.float32)
    rcache = rcache._replace(cross=rblk.build_cross(rp, jnp.asarray(enc_out)))
    _close(cache.cross.k, rcache.cross.k)
    rctx = rm._ctx(params, method, backend="xla")
    bcp = cfg.quoka.chunk_size
    for c0 in range(0, POSITIONS, bcp):
        x = _x((BATCH, bcp, cfg.d_model), 6 + c0)
        pos = np.tile(np.arange(c0, c0 + bcp, dtype=np.int32), (BATCH, 1))
        want, rcache, _, _ = rblk.apply(rp, jnp.asarray(x), jnp.asarray(pos),
                                        rcache, dict(rctx, slot=c0))
        got, _ = blk.apply(_t(x), _t(pos), cache,
                           dict(pm._ctx(method), slot=c0))
        _close(got, want)
        np.testing.assert_array_equal(cache.kv.pos.numpy(),
                                      np.asarray(rcache.kv.pos))
    assert rcfg.quoka.budget + bcp < POSITIONS


# ---------------------------------------------------------------------------
# the frontends
# ---------------------------------------------------------------------------

def test_encode_and_build_cross_match_reference():
    """``Model.encode`` (frames + sinusoidal positions, two enc_attn
    layers, RMSNorm) and every decoder layer's ``CrossKV`` within 1e-4 of
    the reference's."""
    rm, params, pm = _pair("whisper-small")
    frames = _batch(pm.cfg, 7)["frames"]
    want = rm.encode(params, jnp.asarray(frames))
    got = pm.encode(frames)
    _close(got, want)
    rcache = rm._build_cross(params, rm.init_cache(BATCH, POSITIONS), want)
    cache = pm.init_cache(BATCH, POSITIONS)
    pm._build_cross(cache, got)
    period = len(pm.stacks[0].period)
    for li, c in enumerate(cache[0]):
        r, j = divmod(li, period)
        for leaf in ("k", "v"):
            _close(getattr(c.cross, leaf),
                   getattr(rcache.stacks[0][j].cross, leaf)[r])


def test_vlm_embed_inputs_matches_reference_and_refuses_padding():
    """The projector's output (gelu(tanh) of fc1, then fc2) ahead of the
    token embeddings, positions 0 ... n + T - 1, within 1e-4 of the
    reference's; a padded VLM batch raises the reference's error."""
    rm, params, pm = _pair("internvl2-1b")
    batch = _batch(pm.cfg, 8)
    wx, wpos = rm.embed_inputs(params, _j(batch))
    x, pos = pm.embed_inputs(batch)
    assert x.shape == (BATCH, POSITIONS, pm.cfg.d_model)
    _close(x, wx)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(wpos))
    _close(pm.project(batch["patches"]), wx[:, :pm.cfg.frontend.n_tokens])
    padded = dict(batch, pad=np.zeros((BATCH,), np.int32))
    with pytest.raises(ValueError) as want:
        rm.embed_inputs(params, _j(padded))
    with pytest.raises(ValueError) as got:
        pm.embed_inputs(padded)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the models end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,variant", CASES)
def test_logits_and_greedy_tokens_match_reference(arch, variant):
    """Prefill (whisper: the encoder and the cross-attention keys first;
    internvl2: the projected patches first) and three decode steps fed
    the same tokens give the reference's logits within 1e-4, and
    ``generate`` its greedy tokens."""
    method, qover = VARIANTS[variant]
    rm, params, pm = _pair(arch, qover)
    batch = _batch(pm.cfg, 9)
    reng = RefEngine(rm, params, method=method, backend="xla")
    cap = POSITIONS + MAX_NEW + 8                  # on the 16-grid
    rl, rcache = reng._prefill(params, _j(batch), rm.init_cache(BATCH, cap))
    pl, pcache = pm.prefill(batch, pm.init_cache(BATCH, cap), method)
    _close(pl, rl)
    tok = np.asarray(jnp.argmax(rl, axis=-1)).astype(np.int32)
    for i in range(3):
        rl, rcache = reng._decode(params, jnp.asarray(tok),
                                  jnp.asarray(POSITIONS + i), rcache)
        pl, pcache = pm.decode_step(torch.as_tensor(tok).long(),
                                    POSITIONS + i, pcache, method)
        _close(pl, rl)
        tok = np.asarray(jnp.argmax(rl, axis=-1)).astype(np.int32)
    want = reng.generate(_j(batch), MAX_NEW).tokens
    got = Engine(pm, method=method, device="cpu").generate(batch, MAX_NEW)
    np.testing.assert_array_equal(got.tokens, np.asarray(want))
    assert got.prompt_len == batch["tokens"].shape[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_selection_runs_on_the_decoder_self_attention_only(arch):
    """Staged QUOKA calls scoring and attention (on the card: launches the
    kernels) once per decoder layer per selecting chunk; whisper's encoder
    and cross-attention call neither."""
    from repro_torch.kernels import ops
    calls = {"score": 0, "attention": 0}
    orig = (ops.score, ops.attention)

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    ops.score, ops.attention = count("score", orig[0]), count("attention",
                                                              orig[1])
    try:
        _, _, pm = _pair(arch)
        pm.prefill(_batch(pm.cfg, 10), pm.init_cache(BATCH, POSITIONS + 16),
                   "quoka")
    finally:
        ops.score, ops.attention = orig
    # cap 112 > budget 32 + chunk 16: every chunk selects
    want = pm.cfg.n_layers * POSITIONS // pm.cfg.quoka.chunk_size
    assert calls == {"score": want, "attention": want}


@pytest.mark.parametrize("method", ["full", "quoka"])
def test_whisper_chunkwise_equals_monolithic(method):
    """With the cross-attention keys built, ``prefill_chunk`` per 16-token
    chunk equals the monolithic ``prefill`` (logits within 2e-3, as the
    reference's test; KV positions identical, caches within 1e-5)."""
    _, _, pm = _pair("whisper-small")
    batch = _batch(pm.cfg, 11)
    toks = batch["tokens"][:, :64]
    lm, c1 = pm.prefill(dict(batch, tokens=toks), pm.init_cache(BATCH, 96),
                        method)
    c2 = pm.init_cache(BATCH, 96)
    pm._build_cross(c2, pm.encode(batch["frames"]))
    bcp = pm.cfg.quoka.chunk_size
    for c0 in range(0, 64, bcp):
        last, c2 = pm.prefill_chunk({"tokens": toks[:, c0:c0 + bcp]}, c0,
                                    c2, method)
    lc = pm._readout(last[:, None, :])[:, 0]
    np.testing.assert_allclose(lc.numpy(), lm.numpy(), atol=2e-3, rtol=2e-3)
    for a, b in zip(c1[0], c2[0]):
        np.testing.assert_array_equal(a.kv.pos.numpy(), b.kv.pos.numpy())
        for x, y in ((a.kv.k, b.kv.k), (a.kv.v, b.kv.v),
                     (a.cross.k, b.cross.k), (a.cross.v, b.cross.v)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5,
                                       rtol=0)


@pytest.mark.parametrize("arch,change", [
    ("whisper-small", "frontend"), ("internvl2-1b", "encoder"),
    ("llama3-2-3b", "encoder"), ("llama3-2-3b", "frontend")])
def test_model_refuses_a_frontend_or_encoder_it_would_not_read(arch, change):
    """An encoder belongs to family ``audio`` and a frontend to ``vlm``:
    a model of another family would ignore it, so ``Model`` refuses it,
    and ``prefix_positions`` counts a VLM's patches only."""
    from repro_torch.configs.base import EncoderConfig, FrontendConfig
    from repro_torch.models.model import Model
    cfg = port_config(arch).smoke()
    extra = {"frontend": FrontendConfig(n_tokens=16, d_in=128),
             "encoder": EncoderConfig(n_layers=2, n_ctx=64)}[change]
    with pytest.raises(ValueError, match="an encoder belongs to family"):
        Model(dataclasses.replace(cfg, **{change: extra}), "cpu")
    assert cfg.prefix_positions == (16 if cfg.family == "vlm" else 0)
