"""The port's training loss and gradients against the reference's
``jax.value_and_grad`` for the recurrent and modality families, on the
CPU, fp32 at smoke size (the helper and the tolerances of
``test_torch_train_grads.py``): zamba2-7b (``mamba`` and
``mamba_shared_attn``, the one shared block's gradient summed over its
uses; 96 tokens, two SSD sub-chunks with padding), rwkv6-1.6b, whisper-small
(the encoder over its frames and ``dec_cross``) and internvl2-1b (the
projector; the patch positions dropped from the loss).

rwkv6 needs a looser gradient tolerance: its largest error at this
input, 3.0e-3 of the leaf's largest magnitude (``stacks/0/0/tm/u``), is
the conditioning of the wkv recurrence in fp32, not a fault: a float64
run of the port puts the reference's fp32 gradient 1.25e-3 and the
port's 1.76e-3 from it on that leaf, and the two chunked scans' own
gradients agree within 6e-6 of a float64 per-token recurrence.  The loss
agrees to the last bit.

Also: remat on equals remat off (loss and every gradient) per family.
"""
import dataclasses

import jax
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.model import build_model as ref_build
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config as port_config
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import loop
from test_torch_train_grads import _batch, check_grads

torch.set_num_threads(2)

RWKV_GRAD_TOL = 5e-3


def test_zamba2_mamba_and_shared_block():
    _, errs = check_grads("zamba2-7b", t=96)
    assert any(k.startswith("shared/") for k in errs)


def test_rwkv6():
    check_grads("rwkv6-1.6b", t=40, tol=RWKV_GRAD_TOL)


def test_whisper_encoder_and_dec_cross():
    _, errs = check_grads("whisper-small")
    assert any(k.startswith("enc/stack/") for k in errs)


def test_internvl2_patches_out_of_the_loss():
    _, errs = check_grads("internvl2-1b")
    assert any(k.startswith("proj/") for k in errs)


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b",
                                  "zamba2-7b", "rwkv6-1.6b", "whisper-small",
                                  "internvl2-1b"])
def test_remat_equals_no_remat(arch):
    """Each layer recomputed in the backward gives the same loss and
    gradients (the same operations in the same order)."""
    flat = _flatten(ref_build(ref_config(arch).smoke()).init(
        jax.random.PRNGKey(0)))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(port_config(arch).smoke(), remat=remat)
        model = ckpt.from_flat(flat, cfg, "cpu")
        loop.init_state(model, None)
        out.append(loop.value_and_grad(model, _batch(cfg, 2, 48, 2)))
    (l0, g0), (l1, g1) = out
    assert float(l0) == float(l1)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
