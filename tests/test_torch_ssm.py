"""The recurrent families in the port against the JAX reference at smoke
size, on the CPU: zamba2-7b (Mamba2 layers and one shared attention
block, on whose KV caches QUOKA selects) and rwkv6-1.6b (RWKV6, no KV
cache).

Both packages run the same weights through the weight bridge; inputs are
drawn with numpy from a seed.  Checked: the chunked scans
(``mamba2._ssd_chunked``, ``rwkv6._time_mix_chunked``) equal the
reference's to fp32 roundoff at the scale of their outputs (within 1e-6
of the largest |output| on unit-normal inputs, 1e-5 on the inputs the
smoke models give them, padded as their callers pad, where both sides
are also that close to a float64 recurrence: torch's sequential
``cumsum`` and XLA's differ in the last bits, and the decays are
differences of cumulative sums up to ~300 in rwkv6), and a naive
per-token recurrence within 1e-3; a state carried across two
segments equals one segment, and a one-token step the segment's row;
``mamba_apply``, ``time_mix`` and ``channel_mix`` equal the reference's
within 1e-4; prefill and decode logits within 1e-4 and greedy tokens equal
to the reference's ``generate`` (zamba2 under ``full``, staged ``quoka``,
fused ``quoka`` at g = 16 and ``quoka`` with ``reuse_interval`` 2, whose
carry stays off; rwkv6 under ``full`` and ``quoka``); chunkwise prefill
equal to the monolithic one; the shared block's weights one tensor at
every use; the weight bridge holding every reference leaf; the paged
pool's refusal, with the reference's message.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import mamba2 as ref_mamba2
from repro.models import rwkv6 as ref_rwkv6
from repro.models.model import build_model as ref_build
from repro.serving import pool as ref_pool
from repro.serving.engine import Engine as RefEngine
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config as port_config
from repro_torch.kernels import flash_attention, quoka_score
from repro_torch.kernels import selected_attention
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.blocks import AttnBlock
from repro_torch.models.model import Model
from repro_torch.serving import cache as port_cache
from repro_torch.serving.engine import Engine
from repro_torch.serving.pool import PagedKVCache
from repro_torch.serving.request import make_requests
from repro_torch.training.checkpoint import from_flat

torch.set_num_threads(2)

LOGIT_TOL = 1e-4
PROMPT, MAX_NEW, BATCH = 96, 8, 2        # 96 > budget 32 + chunk 16

VARIANTS = {
    "zamba2-7b": {
        "full": ("full", {}),
        "quoka_staged": ("quoka", {}),
        "quoka_g16_fused": ("quoka", {"granularity": 16,
                                      "fused_select_attn": True}),
        "quoka_reuse2": ("quoka", {"reuse_interval": 2}),
    },
    "rwkv6-1.6b": {
        "full": ("full", {}),
        "quoka": ("quoka", {}),
    },
}
CASES = [(a, v) for a in VARIANTS for v in sorted(VARIANTS[a])]


def _pair(arch, qover=None, **over):
    """(reference model, its params, the port's model with those weights)."""
    qover = qover or {}
    rc = ref_config(arch).smoke(**over)
    rc = dataclasses.replace(rc, quoka=dataclasses.replace(rc.quoka, **qover))
    pc = port_config(arch).smoke(**over)
    pc = dataclasses.replace(pc, quoka=dataclasses.replace(pc.quoka, **qover))
    rm = ref_build(rc)
    params = rm.init(jax.random.PRNGKey(0))
    return rm, params, from_flat(_flatten(params), pc, "cpu")


def _tokens(seed, vocab, t=PROMPT, b=BATCH):
    return np.random.default_rng(seed).integers(
        3, vocab, (b, t)).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# the scans: the reference's functions and a naive recurrence
# ---------------------------------------------------------------------------

def _naive_ssd(x, dt, la, B, C, state):
    """S_t = exp(la_t) S_{t-1} + dt_t x_t B_t^T;  y_t = S_t C_t."""
    S = np.asarray(state, np.float64)
    xs, dts, Bs, Cs = (np.asarray(a, np.float64) for a in (x, dt, B, C))
    an = np.exp(np.asarray(la, np.float64))
    ys = []
    for i in range(xs.shape[1]):
        S = an[:, i][:, :, None, None] * S + np.einsum(
            "bh,bhp,bn->bhpn", dts[:, i], xs[:, i], Bs[:, i])
        ys.append(np.einsum("bhpn,bn->bhp", S, Cs[:, i]))
    return np.stack(ys, axis=1), S


def _naive_rwkv(r, k, v, lw, u, state):
    """o_t = r_t (S_{t-1} + (u * k_t) v_t^T);
    S_t = diag(w_t) S + k_t v_t^T."""
    S = np.asarray(state, np.float64)
    rn, kn, vn = (np.asarray(a, np.float64) for a in (r, k, v))
    wn = np.exp(np.asarray(lw, np.float64))
    un = np.asarray(u, np.float64)
    outs = []
    for i in range(rn.shape[1]):
        bonus = np.einsum("bhd,bhe->bhde", un[None] * kn[:, i], vn[:, i])
        outs.append(np.einsum("bhd,bhde->bhe", rn[:, i], S + bonus))
        S = wn[:, i][..., None] * S + np.einsum("bhd,bhe->bhde", kn[:, i],
                                                vn[:, i])
    return np.stack(outs, axis=1), S


def _ssd_inputs(t, b=2, h=3, p=4, n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    la = (-dt * 0.5).astype(np.float32)
    B = rng.standard_normal((b, t, n)).astype(np.float32)
    C = rng.standard_normal((b, t, n)).astype(np.float32)
    S0 = (rng.standard_normal((b, h, p, n)) * 0.1).astype(np.float32)
    return x, dt, la, B, C, S0


def _rwkv_inputs(t, b=2, h=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32)
               for _ in range(3))
    lw = -np.exp(rng.standard_normal((b, t, h, d)) - 1.0).astype(np.float32)
    u = (rng.standard_normal((h, d)) * 0.1).astype(np.float32)
    S0 = (rng.standard_normal((b, h, d, d)) * 0.1).astype(np.float32)
    return r, k, v, lw, u, S0


def _pad_time(a, chunk):
    """Zeros after the last step up to the sub-chunk, as the callers pad
    (a zero log-decay keeps the state, zero inputs add nothing)."""
    pad = (-a.shape[1]) % chunk
    return np.pad(a, ((0, 0), (0, pad)) + ((0, 0),) * (a.ndim - 2))


def _close_to_scale(got, want, rel):
    """Within ``rel`` of the largest |want|: fp32 sums whose order
    differs round at the scale of their largest terms."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=rel * float(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("t", [70, 133])
def test_ssd_chunked_matches_reference_and_naive(t):
    x, dt, la, B, C, S0 = _ssd_inputs(t)
    padded = [_pad_time(a, mamba2.CHUNK) for a in (x, dt, la, B, C)]
    y, S = mamba2._ssd_chunked(*map(_t, padded), _t(S0))
    wy, wS = ref_mamba2._ssd_chunked(*map(jnp.asarray, padded),
                                     jnp.asarray(S0))
    _close_to_scale(y, wy, 1e-6)
    _close_to_scale(S, wS, 1e-6)
    ny, nS = _naive_ssd(x, dt, la, B, C, S0)
    np.testing.assert_allclose(y.numpy()[:, :t], ny, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(S.numpy(), nS, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("t", [37, 50])
def test_time_mix_chunked_matches_reference_and_naive(t):
    r, k, v, lw, u, S0 = _rwkv_inputs(t)
    padded = [_pad_time(a, rwkv6.CHUNK) for a in (r, k, v, lw)]
    out, S = rwkv6._time_mix_chunked(*map(_t, padded), _t(u), _t(S0))
    wo, wS = ref_rwkv6._time_mix_chunked(*map(jnp.asarray, padded),
                                         jnp.asarray(u), jnp.asarray(S0))
    _close_to_scale(out, wo, 1e-6)
    _close_to_scale(S, wS, 1e-6)
    no, nS = _naive_rwkv(r, k, v, lw, u, S0)
    np.testing.assert_allclose(out.numpy()[:, :t], no, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(S.numpy(), nS, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_scans_on_the_models_inputs_match_reference(arch):
    """The scan's inputs as layer 0 of the smoke model builds them from a
    100-token segment (padded to the sub-chunk by the caller) from a
    nonzero state: the port's scan and the reference's both lie within
    1e-5 of the largest |output| of the float64 recurrence and of each
    other."""
    rp, blk, rcfg, cfg = _layer0(arch)
    mod = mamba2 if arch == "zamba2-7b" else rwkv6
    name = "_ssd_chunked" if arch == "zamba2-7b" else "_time_mix_chunked"
    seen = []
    scan = getattr(mod, name)

    def spy(*args):
        seen.append([a.clone() for a in args])
        return scan(*args)
    x = _t(_x((2, 100, cfg.d_model), 11))
    cache = blk.init_cache(2, 0)
    for leaf in cache:
        leaf.copy_(_t(_x(leaf.shape, 12) * 0.1))
    setattr(mod, name, spy)
    try:
        if arch == "zamba2-7b":
            mamba2.mamba_apply(blk.mamba, x, cache, cfg)
        else:
            rwkv6.time_mix(blk.tm, x, cache.shift_tm, cache.wkv, cfg)
    finally:
        setattr(mod, name, scan)
    (args,) = seen
    # 100 padded to the sub-chunk: 128 (Mamba2, 64) or 112 (RWKV6, 16)
    assert args[0].shape[1] == -(-100 // mod.CHUNK) * mod.CHUNK > 100
    got = scan(*args)
    want = getattr(ref_mamba2 if arch == "zamba2-7b" else ref_rwkv6, name)(
        *(jnp.asarray(a.numpy()) for a in args))
    naive = _naive_ssd if arch == "zamba2-7b" else _naive_rwkv
    exact = naive(*(a.numpy() for a in args))
    for g, w, e in zip(got, want, exact):
        _close_to_scale(g, w, 1e-5)
        _close_to_scale(g, e, 1e-5)
        _close_to_scale(torch.as_tensor(np.array(w)), e, 1e-5)


# ---------------------------------------------------------------------------
# the mixers: against the reference's, and state carried across segments
# ---------------------------------------------------------------------------

def _layer0(arch):
    """(layer 0's reference params, its port block, the reference's and
    the port's configs)."""
    rm, params, pm = _pair(arch)
    rp = jax.tree.map(lambda a: a[0], params["stacks"][0][0])
    return rp, pm.stacks[0].layers[0], rm.cfg, pm.cfg


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_mamba_apply_matches_reference_and_carries_state():
    """A 45-token segment from a nonzero state: output, convolution tail
    and SSD state within 1e-4 of the reference's; [x1; x2] in two calls
    equals one call, and a one-token step equals the segment's row."""
    rp, blk, rcfg, cfg = _layer0("zamba2-7b")
    p = blk.mamba
    b, t = 2, 45
    x = _x((b, t, cfg.d_model), 1)
    c0 = blk.init_cache(b, 0)
    c0.conv.copy_(_t(_x(c0.conv.shape, 2)))
    c0.ssd.copy_(_t(_x(c0.ssd.shape, 3) * 0.1))
    rc0 = ref_mamba2.MambaCache(conv=jnp.asarray(c0.conv.numpy()),
                                ssd=jnp.asarray(c0.ssd.numpy()))
    y, c1 = mamba2.mamba_apply(p, _t(x), c0, cfg)
    wy, wc = ref_mamba2.mamba_apply(rp["mamba"], jnp.asarray(x), rc0, rcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-4, rtol=0)
    for got, want in zip(c1, wc):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
    y1, s1 = mamba2.mamba_apply(p, _t(x[:, :20]), c0, cfg)
    y2, _ = mamba2.mamba_apply(p, _t(x[:, 20:]), s1, cfg)
    np.testing.assert_allclose(y2.numpy(), y[:, 20:].numpy(), atol=2e-4,
                               rtol=0)
    y3, _ = mamba2.mamba_apply(p, _t(x[:, 20:21]), s1, cfg)
    np.testing.assert_allclose(y3.numpy(), y[:, 20:21].numpy(), atol=2e-4,
                               rtol=0)


def test_time_mix_and_channel_mix_match_reference_and_carry_state():
    """time_mix (from a nonzero shift and wkv state) and channel_mix on a
    37-token segment within 1e-4 of the reference's, the new shifts the
    normed inputs' last tokens; two segments equal one, a one-token step
    the segment's row."""
    rp, blk, rcfg, cfg = _layer0("rwkv6-1.6b")
    b, t, d = 2, 37, cfg.d_model
    hd = cfg.rwkv.head_dim
    x = _x((b, t, d), 4)
    sh = _x((b, d), 5)
    wkv = _x((b, d // hd, hd, hd), 6) * 0.1
    y, nsh, S = rwkv6.time_mix(blk.tm, _t(x), _t(sh), _t(wkv), cfg)
    wy, wsh, wS = ref_rwkv6.time_mix(rp["tm"], jnp.asarray(x),
                                     jnp.asarray(sh), jnp.asarray(wkv),
                                     rcfg)
    for got, want in ((y, wy), (nsh, wsh), (S, wS)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
    np.testing.assert_array_equal(nsh.numpy(), x[:, -1])
    yc, csh = rwkv6.channel_mix(blk.cm, _t(x), _t(sh))
    wyc, wcsh = ref_rwkv6.channel_mix(rp["cm"], jnp.asarray(x),
                                      jnp.asarray(sh))
    np.testing.assert_allclose(yc.numpy(), np.asarray(wyc), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(csh.numpy(), np.asarray(wcsh))
    y1, sh1, S1 = rwkv6.time_mix(blk.tm, _t(x[:, :20]), _t(sh), _t(wkv), cfg)
    y2, _, S2 = rwkv6.time_mix(blk.tm, _t(x[:, 20:]), sh1, S1, cfg)
    np.testing.assert_allclose(y2.numpy(), y[:, 20:].numpy(), atol=2e-4,
                               rtol=0)
    np.testing.assert_allclose(S2.numpy(), S.numpy(), atol=2e-4, rtol=0)
    y3, _, _ = rwkv6.time_mix(blk.tm, _t(x[:, 20:21]), sh1, S1, cfg)
    np.testing.assert_allclose(y3.numpy(), y[:, 20:21].numpy(), atol=2e-4,
                               rtol=0)


# ---------------------------------------------------------------------------
# the models end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,variant", CASES)
def test_logits_and_greedy_tokens_match_reference(arch, variant):
    """Prefill and three decode steps fed the same tokens give the
    reference's logits within 1e-4, and ``generate`` its greedy tokens;
    every recurrent state after the prefill within 1e-5 of the largest
    |state| of the reference's, the shared block's KV positions exact."""
    method, qover = VARIANTS[arch][variant]
    rm, params, pm = _pair(arch, qover)
    toks = _tokens(2, rm.cfg.vocab)
    reng = RefEngine(rm, params, method=method, backend="xla")
    cap = PROMPT + MAX_NEW + 8                     # on the 16-grid
    rl, rcache = reng._prefill(params, {"tokens": jnp.asarray(toks)},
                               rm.init_cache(BATCH, cap))
    pl, pcache = pm.prefill({"tokens": toks}, pm.init_cache(BATCH, cap),
                            method)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=LOGIT_TOL,
                               rtol=0)
    for si, stack in enumerate(pm.stacks):
        n_period = len(stack.period)
        for li, c in enumerate(pcache[si]):
            r, j = divmod(li, n_period)
            want = rcache.stacks[si][j]
            if isinstance(c, port_cache.SharedAttnCache):
                np.testing.assert_array_equal(c.kv.pos.numpy(),
                                              np.asarray(want.kv.pos[r]))
                c = c.mamba
            ref_state = want.mamba if want.mamba != () else want.rwkv
            for got, w in zip(c, ref_state):
                _close_to_scale(got, w[r], 1e-5)
    tok = np.asarray(jnp.argmax(rl, axis=-1)).astype(np.int32)
    for i in range(3):
        rl, rcache = reng._decode(params, jnp.asarray(tok),
                                  jnp.asarray(PROMPT + i), rcache)
        pl, pcache = pm.decode_step(torch.as_tensor(tok).long(), PROMPT + i,
                                    pcache, method)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl),
                                   atol=LOGIT_TOL, rtol=0)
        tok = np.asarray(jnp.argmax(rl, axis=-1)).astype(np.int32)
    want = reng.generate({"tokens": jnp.asarray(toks)}, MAX_NEW).tokens
    got = Engine(pm, method=method, device="cpu").generate(
        {"tokens": toks}, MAX_NEW).tokens
    np.testing.assert_array_equal(got, np.asarray(want))


def test_zamba2_selects_on_the_shared_block_only():
    """Staged QUOKA on zamba2 launches (on the CPU: calls) scoring and
    attention once per shared-block use per selecting chunk; the Mamba2
    layers call neither, and rwkv6 calls nothing."""
    calls = {"score": 0, "attention": 0}
    from repro_torch.kernels import ops
    orig = (ops.score, ops.attention)

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    ops.score, ops.attention = count("score", orig[0]), count("attention",
                                                              orig[1])
    try:
        for arch in ("zamba2-7b", "rwkv6-1.6b"):
            calls.update(score=0, attention=0)
            _, _, pm = _pair(arch)
            pm.prefill({"tokens": _tokens(3, pm.cfg.vocab)},
                       pm.init_cache(BATCH, PROMPT + 16), "quoka")
            n_shared = pm.cfg.layer_kinds().count("mamba_shared_attn")
            # cap 112 > budget 32 + chunk 16: every chunk selects
            want = n_shared * PROMPT // pm.cfg.quoka.chunk_size
            assert calls == {"score": want, "attention": want}, arch
    finally:
        ops.score, ops.attention = orig


def test_reuse_carry_stays_off_with_a_plain_mamba_layer():
    """``reuse_interval`` 2: a plain ``mamba`` layer builds no plan, so
    zamba2's stack starts no carry and every shared-block use scores (as
    the reference); a stack of shared layers alone does start one."""
    from repro_torch.core import plan as plan_mod
    _, _, pm = _pair("zamba2-7b", {"reuse_interval": 2})
    stack = pm.stacks[0]
    assert stack.period == ("mamba", "mamba_shared_attn")
    caches = stack.init_cache(BATCH, 128)
    ctx = pm._ctx("quoka")
    assert stack.layers[0].plan_carry_shape(caches[0], 16, "quoka",
                                            pm.cfg.quoka) is None
    assert stack.layers[1].plan_carry_shape(caches[1], 16, "quoka",
                                            pm.cfg.quoka) is not None
    assert stack._plan_carry0(caches, 16, ctx, None, "cpu") is None
    _, _, only = _pair("zamba2-7b", {"reuse_interval": 2},
                       layer_pattern=("mamba_shared_attn",))
    s = only.stacks[0]
    carry = s._plan_carry0(s.init_cache(BATCH, 128), 16, only._ctx("quoka"),
                           None, "cpu")
    assert isinstance(carry, plan_mod.PlanCarry)


def _leaves(x):
    """The tensors of a nest of caches, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _leaves(y)]
    return []


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
@pytest.mark.parametrize("method", ["full", "quoka"])
def test_chunkwise_equals_monolithic(arch, method):
    """``prefill_chunk`` per 16-token chunk equals the monolithic
    ``prefill`` (logits within 2e-3, as the reference's test; KV positions
    identical, recurrent states within 1e-5), as
    ``tests/test_engine_modes.py`` checks the reference."""
    _, _, pm = _pair(arch)
    toks = _tokens(4, pm.cfg.vocab, t=64)
    bcp = pm.cfg.quoka.chunk_size
    logits_mono, cache1 = pm.prefill({"tokens": toks},
                                     pm.init_cache(BATCH, 96), method)
    cache2 = pm.init_cache(BATCH, 96)
    for c0 in range(0, 64, bcp):
        last, cache2 = pm.prefill_chunk({"tokens": toks[:, c0:c0 + bcp]},
                                        c0, cache2, method)
    logits_chunk = pm._readout(last[:, None, :])[:, 0]
    np.testing.assert_allclose(logits_chunk.numpy(), logits_mono.numpy(),
                               atol=2e-3, rtol=2e-3)
    for a, b in zip(_leaves(cache1), _leaves(cache2)):
        if a.dtype == torch.int32:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       rtol=0)


def test_padded_prompt_matches_reference():
    """A left-padded prompt (pad slots at position -1: rwkv6 adds their
    sinusoidal embedding, and both families read the pad embeddings in
    sequence, as the reference's recurrent blocks do) gives the
    reference's greedy tokens."""
    for arch in ("zamba2-7b", "rwkv6-1.6b"):
        rm, params, pm = _pair(arch)
        toks = _tokens(6, pm.cfg.vocab, t=40)
        eng = Engine(pm, method="quoka", device="cpu")
        batch = eng.pad_prompt(toks)
        assert batch["pad"][0] == 8
        want = RefEngine(rm, params, method="quoka", backend="xla").generate(
            {k: jnp.asarray(v) for k, v in batch.items()}, 4).tokens
        np.testing.assert_array_equal(eng.generate(batch, 4).tokens,
                                      np.asarray(want))


def test_shared_block_is_one_set_of_weights():
    """zamba2 at 12 layers (two periods of 5 mamba + 1 shared): the model
    owns ONE shared ``AttnBlock``, no layer holds one, both uses call it
    with its one weight tensor and their own KV caches, the state dict
    holds it once and round-trips, and the bridge carries every
    reference leaf (total elements equal, ``shared/*`` included)."""
    pattern = ref_config("zamba2-7b").layer_pattern
    rm, params, pm = _pair("zamba2-7b", n_layers=12, layer_pattern=pattern)
    assert pm.cfg.layer_kinds().count("mamba_shared_attn") == 2
    assert isinstance(pm.shared, AttnBlock)
    assert not any(isinstance(m, AttnBlock) for blk in pm.layers()
                   for m in blk.modules())
    flat = _flatten(params)
    assert sum(p.numel() for p in pm.parameters()) == \
        sum(a.size for a in flat.values())
    np.testing.assert_array_equal(pm.shared.wq.numpy(), flat["shared/wq/w"])
    keys = [k for k in pm.state_dict() if ".wq" in k]
    assert keys == ["shared.wq"]
    seen = []
    apply = AttnBlock.apply

    def spy(self, x, pos, kv, ctx, plan=None):
        seen.append((self.wq.data_ptr(), kv.k.data_ptr()))
        return apply(self, x, pos, kv, ctx, plan)
    AttnBlock.apply = spy
    try:
        pm.prefill({"tokens": _tokens(7, pm.cfg.vocab, t=16)},
                   pm.init_cache(BATCH, 32))
    finally:
        AttnBlock.apply = apply
    assert len(seen) == 2 and seen[0][0] == seen[1][0] == \
        pm.shared.wq.data_ptr() and seen[0][1] != seen[1][1]
    copy = Model(pm.cfg, "cpu")
    copy.load_state_dict(pm.state_dict())
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(copy.state_dict()[k], v, rtol=0, atol=0)
    toks = _tokens(8, pm.cfg.vocab, t=48)
    np.testing.assert_array_equal(
        Engine(copy, device="cpu").generate({"tokens": toks}, 4).tokens,
        Engine(pm, device="cpu").generate({"tokens": toks}, 4).tokens)


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_pool_refuses_recurrent_models_like_reference(arch):
    """The paged pool refuses a model with recurrent layers, with the
    reference's message; ``serve`` raises it, ``generate`` runs (rwkv6
    launches nothing: no layer has a KV cache)."""
    rm, params, pm = _pair(arch)
    with pytest.raises(ValueError) as want:
        ref_pool.PagedKVCache(rm, num_blocks=8, block_size=16)
    with pytest.raises(ValueError) as got:
        PagedKVCache(pm, num_blocks=8, block_size=16)
    assert str(got.value) == str(want.value)
    kinds = ["mamba", "mamba_shared_attn"] if arch == "zamba2-7b" else \
        ["rwkv"]
    assert f"unsupported block kinds {kinds}" in str(got.value)
    eng = Engine(pm, method="quoka", device="cpu")
    with pytest.raises(ValueError, match="attention/MLA caches only"):
        eng.serve(make_requests([_tokens(9, pm.cfg.vocab, t=48, b=1)[0]],
                                2), block_size=16)
    for mod in (flash_attention, quoka_score, selected_attention):
        mod.LAUNCHES = 0
    assert eng.generate({"tokens": _tokens(9, pm.cfg.vocab)},
                        2).tokens.shape == (BATCH, 2)
    assert (flash_attention.LAUNCHES, quoka_score.LAUNCHES,
            selected_attention.LAUNCHES) == (0, 0, 0)


def test_state_write_is_in_place():
    """A recurrent layer's state tensors are the same objects after a
    step (``Engine.generate`` keeps its cache list), in their dtypes."""
    _, _, pm = _pair("rwkv6-1.6b")
    cache = pm.init_cache(BATCH, 32)
    ptrs = [t.data_ptr() for c in cache[0] for t in c]
    pm.prefill({"tokens": _tokens(10, pm.cfg.vocab, t=16)}, cache)
    assert [t.data_ptr() for c in cache[0] for t in c] == ptrs
    assert cache[0][0].wkv.dtype == torch.float32
    assert float(cache[0][0].wkv.abs().sum()) > 0
