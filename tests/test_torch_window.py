"""Sliding-window attention (``attn_local``) in the port against the JAX
reference at smoke size, on the CPU: gemma3-27b (5 local : 1 global) and
h2o-danube-3-4b (every layer windowed).

Both packages run the same weights through the weight bridge.  The smoke
configs have a window of 64, a budget of 32 and chunks of 16, and the
prompts are 160 tokens, so every ring wraps and QUOKA selects inside the
window.  Checked: ``kv_write_ring`` bit for bit (a chunk that wraps, the
per-row refusal); each layer's cache after a prefill (ring capacity,
positions, K and V); prefill and decode logits within 1e-4 and greedy
tokens equal under ``full``, staged ``quoka``, block-granular ``quoka``
with the fused route on (which a windowed layer declines) and ``quoka``
with cross-layer plan reuse; chunkwise prefill equal to the monolithic
one (mirroring ``tests/test_engine_modes.py``); the weight bridge over
gemma3's one-repeat tail stack; the paged pool's refusal, with the
reference's message.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.model import build_model as ref_build
from repro.serving import cache as ref_cache
from repro.serving import pool as ref_pool
from repro.serving.engine import Engine as RefEngine
from repro.training.checkpoint import _flatten
from repro.training.checkpoint import save as ref_save
from repro_torch.configs import get_config as port_config
from repro_torch.core import plan as port_plan
from repro_torch.kernels import flash_attention, quoka_score
from repro_torch.kernels import selected_attention
from repro_torch.serving import cache as port_cache
from repro_torch.serving.engine import Engine
from repro_torch.serving.pool import PagedKVCache
from repro_torch.serving.request import make_requests
from repro_torch.training.checkpoint import from_flat, restore

torch.set_num_threads(2)

LOGIT_TOL = 1e-4
PROMPT, MAX_NEW, BATCH = 160, 12, 2      # 160 > window 64 > budget 32 + 16
ARCHS = ["gemma3-27b", "h2o-danube-3-4b"]

VARIANTS = {
    "full": ("full", {}),
    "quoka_staged": ("quoka", {}),
    "quoka_g16_fused": ("quoka", {"granularity": 16,
                                  "fused_select_attn": True}),
    "quoka_reuse2": ("quoka", {"reuse_interval": 2}),
}


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


def _tokens(seed, vocab, t=PROMPT, b=BATCH):
    return np.random.default_rng(seed).integers(
        3, vocab, (b, t)).astype(np.int32)


@pytest.mark.parametrize("case", [
    # (cap, t, start): no wrap, a chunk that wraps, one that ends on the
    # ring's last slot, a decode write past several laps
    (64, 16, 0), (64, 16, 56), (64, 16, 112), (64, 1, 200), (48, 16, 40)])
@pytest.mark.parametrize("explicit_pos", [False, True])
def test_kv_write_ring_matches_reference(case, explicit_pos):
    """Slots (start + i) % cap, in place, bit for bit the reference's
    functional write; explicit positions (pad slots -1) ride along."""
    cap, t, start = case
    rng = np.random.default_rng(cap + t + start)
    b, n_kv, d = 2, 2, 8
    k0 = rng.standard_normal((b, cap, n_kv, d)).astype(np.float32)
    v0 = rng.standard_normal((b, cap, n_kv, d)).astype(np.float32)
    pos0 = rng.integers(-1, 50, (b, cap)).astype(np.int32)
    k_new = rng.standard_normal((b, t, n_kv, d)).astype(np.float32)
    v_new = rng.standard_normal((b, t, n_kv, d)).astype(np.float32)
    pos_new = None
    if explicit_pos:
        pos_new = (start + np.arange(t, dtype=np.int32))[None].repeat(b, 0)
        pos_new[1, :t // 2] = -1
    want = ref_cache.kv_write_ring(
        ref_cache.KVCache(jnp.asarray(k0), jnp.asarray(v0),
                          jnp.asarray(pos0)),
        jnp.asarray(k_new), jnp.asarray(v_new), start,
        pos_new=None if pos_new is None else jnp.asarray(pos_new))
    cache = port_cache.KVCache(torch.as_tensor(k0.copy()),
                               torch.as_tensor(v0.copy()),
                               torch.as_tensor(pos0.copy()))
    got = port_cache.kv_write_ring(
        cache, torch.as_tensor(k_new), torch.as_tensor(v_new), start,
        pos_new=None if pos_new is None else torch.as_tensor(pos_new))
    assert got.k.data_ptr() == cache.k.data_ptr()          # in place
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


def test_kv_write_ring_refuses_per_row_start():
    cache = port_cache.kv_init(2, 64, 2, 8, torch.float32, "cpu")
    x = torch.zeros((2, 16, 2, 8))
    with pytest.raises(ValueError, match="paged/continuous"):
        port_cache.kv_write_ring(cache, x, x, torch.tensor([0, 16]))
    port_cache.kv_write_ring(cache, x, x, torch.tensor(16))   # a () tensor


@pytest.mark.parametrize("arch", ARCHS)
def test_window_layer_caches_match_reference(arch):
    """After a 160-token prefill every layer's cache equals the
    reference's: a windowed layer holds a ring of min(cap, window) = 64
    slots (wrapped: its positions are not monotonic in slot order), a
    global one all of cap; positions exact, K and V within 1e-5."""
    rm, params, pm = _pair(arch)
    toks = _tokens(1, rm.cfg.vocab)
    cap = PROMPT + 16
    reng = RefEngine(rm, params, method="quoka", backend="xla")
    _, rcache = reng._prefill(params, {"tokens": jnp.asarray(toks)},
                              rm.init_cache(BATCH, cap))
    _, pcache = pm.prefill({"tokens": toks}, pm.init_cache(BATCH, cap),
                           "quoka")
    for si, stack in enumerate(pm.stacks):
        n_period = len(stack.period)
        for li, (blk, kv) in enumerate(zip(stack.layers, pcache[si])):
            r, j = divmod(li, n_period)
            want = rcache.stacks[si][j].kv
            assert kv.capacity == (64 if blk.kind == "attn_local" else cap)
            np.testing.assert_array_equal(kv.pos.numpy(),
                                          np.asarray(want.pos[r]))
            np.testing.assert_allclose(kv.k.numpy(), np.asarray(want.k[r]),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(kv.v.numpy(), np.asarray(want.v[r]),
                                       atol=1e-5, rtol=0)
            if blk.kind == "attn_local":
                p = kv.pos[0].numpy()
                assert (np.diff(p) < 0).any() and p.max() == PROMPT - 1


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_window_logits_and_greedy_tokens_match_reference(arch, variant):
    """Prefill and three decode steps fed the same tokens give the
    reference's logits within 1e-4, and ``generate`` its greedy tokens."""
    method, qover = VARIANTS[variant]
    rm, params, pm = _pair(arch, qover)
    toks = _tokens(2, rm.cfg.vocab)
    reng = RefEngine(rm, params, method=method, backend="xla")
    peng = Engine(pm, method=method, device="cpu")
    cap = PROMPT + MAX_NEW + 4                   # on the 16-grid
    rl, rcache = reng._prefill(params, {"tokens": jnp.asarray(toks)},
                               rm.init_cache(BATCH, cap))
    pl, pcache = pm.prefill({"tokens": toks}, pm.init_cache(BATCH, cap),
                            method)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=LOGIT_TOL,
                               rtol=0)
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
    got = peng.generate({"tokens": toks}, MAX_NEW).tokens
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_windowed_layers_score_but_never_take_an_attention_kernel(arch):
    """On the fused configuration a windowed layer still selects (scoring
    through ``ops.score``) but attends on the plain masked path: the
    fused route refuses a window, and no attention call comes from it."""
    calls = {"score": 0, "attention": 0, "selected": 0}
    from repro_torch.kernels import ops
    orig = (ops.score, ops.attention, ops.selected_attention)

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    _, _, pm = _pair(arch, VARIANTS["quoka_g16_fused"][1])
    assert not port_plan.fused_route(pm.cfg.quoka, "quoka",
                                     torch.zeros(1, 64), window=64)
    ops.score, ops.attention, ops.selected_attention = (
        count("score", orig[0]), count("attention", orig[1]),
        count("selected", orig[2]))
    try:
        pm.prefill({"tokens": _tokens(3, pm.cfg.vocab)},
                   pm.init_cache(BATCH, PROMPT + 16), "quoka")
    finally:
        ops.score, ops.attention, ops.selected_attention = orig
    kinds = pm.cfg.layer_kinds()
    chunks = PROMPT // pm.cfg.quoka.chunk_size
    # a 64-slot ring selects from the first chunk on (64 > 32 + 16); the
    # global layer's cap of 176 too
    assert calls["score"] == len(kinds) * chunks
    assert calls["attention"] == 0
    assert calls["selected"] == kinds.count("attn") * chunks


@pytest.mark.parametrize("method", ["full", "quoka"])
def test_chunkwise_equals_monolithic(method):
    """gemma3 smoke: ``prefill_chunk`` per 16-token chunk equals the
    monolithic ``prefill`` (logits within 2e-3, as the reference's test;
    positions identical, the rings included), as
    ``tests/test_engine_modes.py`` checks the reference."""
    _, _, pm = _pair("gemma3-27b")
    toks = _tokens(4, pm.cfg.vocab, t=PROMPT)
    bcp = pm.cfg.quoka.chunk_size
    logits_mono, cache1 = pm.prefill({"tokens": toks},
                                     pm.init_cache(BATCH, 192), method)
    cache2 = pm.init_cache(BATCH, 192)
    for c0 in range(0, PROMPT, bcp):
        last, cache2 = pm.prefill_chunk({"tokens": toks[:, c0:c0 + bcp]},
                                        c0, cache2, method)
    logits_chunk = pm._readout(last[:, None, :])[:, 0]
    np.testing.assert_allclose(logits_chunk.numpy(), logits_mono.numpy(),
                               atol=2e-3, rtol=2e-3)
    for a, b in zip([c for s in cache1 for c in s],
                    [c for s in cache2 for c in s]):
        np.testing.assert_array_equal(a.pos.numpy(), b.pos.numpy())


def test_restore_covers_the_one_repeat_tail_stack(tmp_path):
    """gemma3-27b's 62 layers are ten 6-layer periods and a 2-layer tail
    stack of one repeat; at smoke size with 8 layers (one period and a
    2-layer tail) the reference's npz checkpoint loads into the same
    weights as ``from_flat``, every key of it."""
    rc = ref_config("gemma3-27b").smoke(n_layers=8)
    pc = port_config("gemma3-27b").smoke(n_layers=8)
    assert list(pc.stacks()) == list(rc.stacks()) == [
        (("attn_local", "attn"), 4)]
    rc = dataclasses.replace(rc, layer_pattern=ref_config(
        "gemma3-27b").layer_pattern)
    pc = dataclasses.replace(pc, layer_pattern=port_config(
        "gemma3-27b").layer_pattern)
    assert list(pc.stacks()) == list(rc.stacks()) == [
        (("attn_local",) * 5 + ("attn",), 1), (("attn_local",) * 2, 1)]
    rm = ref_build(rc)
    params = rm.init(jax.random.PRNGKey(1))
    path = str(tmp_path / "ckpt")
    ref_save(path, params)
    got = restore(path, pc, "cpu")
    want = from_flat(_flatten(params), pc, "cpu")
    assert got.state_dict().keys() == want.state_dict().keys()
    for k, v in want.state_dict().items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)
    assert sum(p.numel() for p in got.parameters()) == \
        sum(a.size for a in _flatten(params).values())
    toks = _tokens(5, pc.vocab, t=64)
    want_tok = RefEngine(rm, params, method="quoka", backend="xla").generate(
        {"tokens": jnp.asarray(toks)}, 4).tokens
    got_tok = Engine(got, method="quoka", device="cpu").generate(
        {"tokens": toks}, 4).tokens
    np.testing.assert_array_equal(got_tok, np.asarray(want_tok))


@pytest.mark.parametrize("arch", ARCHS)
def test_pool_refuses_window_models_like_reference(arch):
    """The paged pool refuses a model with ``attn_local`` layers (their
    rings wrap at the window, not at a block), with the reference's
    message; ``serve`` raises it, ``generate`` runs."""
    rm, params, pm = _pair(arch)
    with pytest.raises(ValueError) as want:
        ref_pool.PagedKVCache(rm, num_blocks=8, block_size=16)
    with pytest.raises(ValueError) as got:
        PagedKVCache(pm, num_blocks=8, block_size=16)
    assert str(got.value) == str(want.value)
    assert "unsupported block kinds ['attn_local']" in str(got.value)
    eng = Engine(pm, method="quoka", device="cpu")
    prompts = [_tokens(6, pm.cfg.vocab, t=48, b=1)[0]]
    with pytest.raises(ValueError, match="attention/MLA caches only"):
        eng.serve(make_requests(prompts, 2), block_size=16)
    for mod in (flash_attention, quoka_score, selected_attention):
        mod.LAUNCHES = 0
    assert eng.generate({"tokens": _tokens(6, pm.cfg.vocab)},
                        2).tokens.shape == (BATCH, 2)
    assert (flash_attention.LAUNCHES, quoka_score.LAUNCHES,
            selected_attention.LAUNCHES) == (0, 0, 0)
