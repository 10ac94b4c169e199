"""The port's model and engine against the JAX reference at smoke size.

Both packages run the same weights: the reference's initial parameters are
flattened to its checkpoint key paths and loaded into the port through the
weight bridge (``repro_torch/training/checkpoint.py::from_flat``).  Prefill
and decode logits must agree within 1e-4 (fp32; only summation order
differs) and greedy tokens must be identical, for dense attention, QUOKA
token selection through the staged route, and QUOKA block selection (g=16)
through the fused route.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.model import build_model as ref_build
from repro.serving.engine import Engine as RefEngine
from repro.training.checkpoint import _flatten
from repro.training.checkpoint import save as ref_save
from repro_torch.configs import get_config as port_config
from repro_torch.kernels import flash_attention, quoka_score, selected_attention
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.training.checkpoint import from_flat, restore

torch.set_num_threads(2)

LOGIT_TOL = 1e-4
PROMPT, MAX_NEW, BATCH = 64, 16, 2       # 64 > budget 32 + chunk 16

VARIANTS = {
    "full": ("full", {}),
    "quoka_staged": ("quoka", {}),
    "quoka_g16_fused": ("quoka", {"granularity": 16,
                                  "fused_select_attn": True}),
}


def _pair(arch, qover):
    rc = ref_config(arch).smoke()
    rc = dataclasses.replace(rc, quoka=dataclasses.replace(rc.quoka, **qover))
    pc = port_config(arch).smoke()
    pc = dataclasses.replace(pc, quoka=dataclasses.replace(pc.quoka, **qover))
    rm = ref_build(rc)
    params = rm.init(jax.random.PRNGKey(0))
    return rm, params, from_flat(_flatten(params), pc, "cpu")


def _tokens(seed, vocab, t=PROMPT):
    return np.random.default_rng(seed).integers(
        3, vocab, (BATCH, t)).astype(np.int32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-3-2b"])
def test_logits_and_greedy_tokens_match_reference(arch, variant):
    method, qover = VARIANTS[variant]
    rm, params, pm = _pair(arch, qover)
    toks = _tokens(1, rm.cfg.vocab)
    reng = RefEngine(rm, params, method=method, backend="xla")
    peng = Engine(pm, method=method, device="cpu")
    cap = PROMPT + MAX_NEW                    # a multiple of the 16-grid

    # prefill + three decode steps fed the same tokens
    rcache = rm.init_cache(BATCH, cap)
    rl, rcache = reng._prefill(params, {"tokens": jnp.asarray(toks)}, rcache)
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


@pytest.mark.parametrize("variant", ["full", "quoka_staged"])
def test_padded_prompt_greedy_tokens_match_reference(variant):
    method, qover = VARIANTS[variant]
    rm, params, pm = _pair("qwen3-4b", qover)
    toks = _tokens(2, rm.cfg.vocab, t=PROMPT - 7)
    reng = RefEngine(rm, params, method=method, backend="xla")
    peng = Engine(pm, method=method, device="cpu")
    rb = reng.pad_prompt(toks)
    pb = peng.pad_prompt(toks)
    np.testing.assert_array_equal(pb["tokens"], rb["tokens"])
    np.testing.assert_array_equal(pb["pad"], rb["pad"])
    want = reng.generate({k: jnp.asarray(v) for k, v in rb.items()},
                         MAX_NEW)
    got = peng.generate(pb, MAX_NEW)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert got.prompt_len == want.prompt_len == PROMPT - 7


def test_cpu_run_launches_no_kernel():
    """On the CPU every wrapper takes its plain version: no launch counted."""
    for mod in (flash_attention, quoka_score, selected_attention):
        mod.LAUNCHES = 0
    _, _, pm = _pair("qwen3-4b", VARIANTS["quoka_g16_fused"][1])
    Engine(pm, device="cpu").generate({"tokens": _tokens(3, 512)}, 2)
    _, _, pm = _pair("qwen3-4b", {})
    Engine(pm, device="cpu").generate({"tokens": _tokens(3, 512)}, 2)
    assert (flash_attention.LAUNCHES, quoka_score.LAUNCHES,
            selected_attention.LAUNCHES) == (0, 0, 0)


def test_top_p_degenerate_cutoff_keeps_argmax():
    """A top-p smaller than the max probability leaves a one-token nucleus
    (the max-prob token), and a top-p above 1 keeps every token: the
    clamped-cutoff edges of the reference's sampler."""
    rng = np.random.default_rng(4)
    logits = torch.as_tensor(rng.normal(size=(4, 64)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    tiny = SamplerConfig(temperature=1.0, top_p=1e-6)
    for _ in range(5):
        np.testing.assert_array_equal(sample(logits, gen, tiny).numpy(),
                                      logits.argmax(-1).numpy())
    from repro_torch.serving.sampler import filter_logits
    kept = filter_logits(logits, SamplerConfig(temperature=1.0, top_p=1.5))
    assert bool(torch.isfinite(kept).all())


def test_restore_reads_reference_checkpoint(tmp_path):
    """``restore`` loads the reference's npz checkpoint into the same
    weights as ``from_flat`` (linear weights once in the compute dtype)."""
    rm, params, pm = _pair("granite-3-2b", {})
    path = str(tmp_path / "ckpt")
    ref_save(path, params)
    got = restore(path, pm.cfg, "cpu").state_dict()
    want = pm.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
