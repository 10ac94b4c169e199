"""The port's training loss and its gradients against
``jax.value_and_grad`` of the reference's ``Model.loss``, on the CPU, fp32
at smoke size: the attention families.

Both packages hold the same weights (the reference's
``model.init(PRNGKey(0))`` through the weight bridge) and take the same
numpy batch.  Checked: the loss within 1e-5 relative and every gradient
leaf within 1e-4 of that leaf's largest magnitude (the port's gradients
re-stacked under the reference's keys by ``checkpoint.to_flat``), for
granite-3-2b (``attn``), gemma3-27b (``attn_local`` beside ``attn``, 96
tokens past its 64-token window), olmoe-1b-7b (``attn_moe``, its aux loss
in the loss), deepseek-v3 (``mla`` and ``mla_moe``, the MTP head's loss),
and granite with left padding (``pad``: positions -1) and with a
``loss_mask``.  ``test_torch_train_families.py`` holds the other
families.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.model import build_model as ref_build
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config as port_config
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import loop

torch.set_num_threads(2)

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _batch(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.frontend.n_tokens, cfg.frontend.d_in)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    return batch


def _moe(cfg, moe):
    return cfg if moe is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, **moe))


def check_grads(arch, t=32, b=2, seed=0, extra=None, tol=GRAD_TOL,
                moe=None):
    """Loss and every gradient leaf of the port against the reference's
    on one batch (``moe`` overrides both configs' MoE fields).  Returns
    (loss, {key: error relative to the leaf's largest magnitude, or the
    port's largest magnitude where the reference's gradient is zero})."""
    rm = ref_build(_moe(ref_config(arch).smoke(), moe))
    params = rm.init(jax.random.PRNGKey(0))
    model = ckpt.from_flat(_flatten(params),
                           _moe(port_config(arch).smoke(), moe), "cpu")
    batch = _batch(rm.cfg, b, t, seed)
    batch.update(extra or {})
    want_loss, want = jax.jit(jax.value_and_grad(rm.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loop.init_state(model, None)
    loss, grads = loop.value_and_grad(model, batch)
    assert abs(float(loss) - float(want_loss)) \
        <= LOSS_TOL * abs(float(want_loss)), (float(loss), float(want_loss))
    index = {p: i for i, p in enumerate(model.parameters())}
    got = ckpt.to_flat(model, lambda p: torch.zeros_like(p)
                       if grads[index[p]] is None else grads[index[p]])
    want = _flatten(want)
    assert set(got) == set(want)
    errs = {}
    for k, w in want.items():
        w = np.asarray(w)
        top = np.abs(w).max()
        err = np.abs(got[k] - w).max()
        errs[k] = float(err / top if top > 0 else err)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (worst, errs[worst])
    return float(loss), errs


def test_granite_attn():
    check_grads("granite-3-2b")


def test_gemma3_sliding_window():
    """96 tokens through a 64-token window: the window masks keys."""
    check_grads("gemma3-27b", t=96)


def test_olmoe_moe_aux_loss():
    """The MoE's load-balance loss enters the loss and its router's
    gradient (dense dispatch at smoke size, as the reference's)."""
    loss, errs = check_grads("olmoe-1b-7b")
    assert any(k.endswith("moe/router/w") for k in errs)


def test_olmoe_capacity_dispatch():
    """The capacity dispatch at a factor that drops pairs: the same drops
    on both sides, so the same gradients."""
    check_grads("olmoe-1b-7b", seed=3,
                moe=dict(dispatch="capacity", capacity_factor=0.5))


def test_deepseek_mla_and_mtp():
    """``mla`` then ``mla_moe``, and the MTP head, whose leaves get their
    gradient only through the MTP loss."""
    _, errs = check_grads("deepseek-v3-671b")
    assert any(k.startswith("mtp/block/") for k in errs)


def test_left_padding():
    """Rows left-padded by 0 and 7 slots (pos -1: masked from attention,
    fully-masked rows give zeros, as the reference)."""
    check_grads("granite-3-2b", extra={"pad": np.array([0, 7], np.int32)})


def test_loss_mask():
    mask = (np.random.default_rng(9).random((2, 32)) < 0.3).astype(
        np.float32)
    check_grads("granite-3-2b", extra={"loss_mask": mask})


def test_loss_mask_all_zero_counts_the_aux_only():
    """A mask with no position: the masked mean divides by at least 1,
    as the reference's ``maximum(m.sum(), 1)``."""
    loss, _ = check_grads("olmoe-1b-7b",
                          extra={"loss_mask": np.zeros((2, 32), np.float32)})
    assert 0 < loss < 1


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b"])
def test_loss_is_next_token_cross_entropy(arch):
    """``loss`` is the mean next-token cross entropy of ``train_logits``
    plus its aux, held here to a plain log-softmax."""
    model = ckpt.from_flat(_flatten(ref_build(ref_config(arch).smoke()).init(
        jax.random.PRNGKey(0))), port_config(arch).smoke(), "cpu")
    batch = _batch(model.cfg, 2, 24, 5)
    with torch.no_grad():
        logits, aux = model.train_logits(batch)
        tok = torch.as_tensor(batch["tokens"]).long()
        ll = torch.log_softmax(logits[:, :-1], dim=-1)
        nll = -ll.gather(-1, tok[:, 1:, None])[..., 0]
        want = float(nll.mean() + aux)
        assert abs(float(model.loss(batch)) - want) <= 1e-6 * abs(want)
        assert (float(aux) > 0) == (arch == "deepseek-v3-671b")
