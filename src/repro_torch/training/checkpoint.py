"""Weight bridge from the reference's parameters (counterpart of
``repro/training/checkpoint.py``).

The reference flattens its parameter pytree to '/'-joined key paths
(``embed/emb``, ``ln_f/g``, ``stacks/<stack>/<period position>/wq/w``, ...)
and saves them with ``np.savez``.  Stacked layer leaves carry a leading
``(repeats, ...)`` axis; row ``r`` of period position ``j`` is the port's
layer ``r * len(period) + j`` of that stack.  Each linear weight is stored
once in the compute dtype; the embedding, an untied ``lm_head`` and the
norm gains stay fp32.  MoE blocks add ``moe/router/w``, the expert stacks
``moe/gate``, ``moe/up``, ``moe/down`` and ``moe/shared/*``; MLA blocks
``wq_a/w``, ``q_ln/g``, ``wq_b/w``, ``wkv_a/w``, ``kv_ln/g``, ``wk_b``,
``wv_b``; an MTP model ``mtp/block/*`` (one unstacked block), ``mtp/ln/g``
and ``mtp/mix/w``.  Mamba2 blocks hold ``ln/g`` and ``mamba/*`` (the
projections' ``*/w``, the split convolution's weights and biases,
``a_log``, ``d_skip``, ``dt_bias``, ``norm/g``), zamba2's one shared
attention block the top-level ``shared/*`` (unstacked), and RWKV6 blocks
``ln1/g``, ``ln2/g``, ``tm/*`` and ``cm/*`` (the shift mixes ``mu``, the
decay ``w0`` / ``wa`` / ``wb``, the bonus ``u``).  Whisper's LayerNorms add
a bias ``*/b`` beside each gain; its decoder blocks hold the
self-attention block under ``self/*`` and ``ln_x/{g,b}``,
``x{q,k,v,o}/w``, its encoder ``enc/stack/0/*`` (one period position,
stacked over the encoder's layers) and ``enc/ln/g``; internvl2's
projector ``proj/fc{1,2}/{w,b}``.
``load_score_projection`` bridges the one array that is not a parameter:
the cached low-rank scoring projection.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.blocks import (DecCrossBlock, MambaBlock, MLABlock,
                                      RWKVBlock)
from repro_torch.models.model import Model


def _module_leaves(prefix: str, mod, linears) -> Dict[str, torch.Tensor]:
    """A recurrent mixer's parameters: ``linears`` as ``<name>/w``, a norm
    gain as ``norm/g``, the rest bare."""
    return {f"{prefix}/{n}/w" if n in linears else
            f"{prefix}/{n}/g" if n == "norm" else f"{prefix}/{n}": p
            for n, p in mod.named_parameters()}


def _block_leaves(blk) -> Dict[str, torch.Tensor]:
    """A block's parameters under the reference's key suffixes."""
    if isinstance(blk, MambaBlock):
        return {"ln/g": blk.ln, **_module_leaves("mamba", blk.mamba,
                                                 mamba2.LINEARS)}
    if isinstance(blk, RWKVBlock):
        return {"ln1/g": blk.ln1, "ln2/g": blk.ln2,
                **_module_leaves("tm", blk.tm, rwkv6.TM_LINEARS),
                **_module_leaves("cm", blk.cm, rwkv6.CM_LINEARS)}
    if isinstance(blk, DecCrossBlock):
        return {**{f"self/{k}": p
                   for k, p in _block_leaves(blk.self_attn).items()},
                **_norm_leaves(blk, "ln_x"), "xq/w": blk.xq, "xk/w": blk.xk,
                "xv/w": blk.xv, "xo/w": blk.xo}
    out = {**_norm_leaves(blk, "ln1"), **_norm_leaves(blk, "ln2"),
           "wo/w": blk.wo}
    if isinstance(blk, MLABlock):
        out.update({"wq_a/w": blk.wq_a, "q_ln/g": blk.q_ln,
                    "wq_b/w": blk.wq_b, "wkv_a/w": blk.wkv_a,
                    "kv_ln/g": blk.kv_ln, "wk_b": blk.wk_b,
                    "wv_b": blk.wv_b})
    else:
        out.update({"wq/w": blk.wq, "wk/w": blk.wk, "wv/w": blk.wv})
    if hasattr(blk, "moe"):
        out.update({"moe/router/w": blk.moe.router, "moe/gate": blk.moe.gate,
                    "moe/up": blk.moe.up, "moe/down": blk.moe.down})
        out.update({f"moe/shared/{k}/w": p
                    for k, p in blk.moe.shared.items()})
    else:
        out.update({f"mlp/{k}/w": p for k, p in blk.mlp.items()})
    return out


def _norm_leaves(blk, name) -> Dict[str, torch.Tensor]:
    """A block norm's gain ``<name>/g`` and, for a LayerNorm, its bias
    ``<name>/b``."""
    out = {f"{name}/g": getattr(blk, name)}
    if hasattr(blk, name + "_b"):
        out[f"{name}/b"] = getattr(blk, name + "_b")
    return out


def _stacked(flat, prefix: str, stack, expected: set) -> None:
    """Copy a stack's leaves ``<prefix>/<period position>/<suffix>``, each
    with its leading (repeats, ...) axis, into the stack's layers."""
    n_period = len(stack.period)
    for j in range(n_period):
        for suffix in _block_leaves(stack.layers[j]):
            key = f"{prefix}/{j}/{suffix}"
            expected.add(key)
            arr = flat[key]
            if arr.shape[0] != stack.repeats:
                raise ValueError(f"{key}: {arr.shape[0]} repeats, "
                                 f"expected {stack.repeats}")
            for r in range(stack.repeats):
                _copy(_block_leaves(stack.layers[r * n_period + j])[suffix],
                      arr[r], key)


def _copy(param: torch.Tensor, arr: np.ndarray, key: str) -> None:
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{key}: shape {arr.shape} != {tuple(param.shape)}")
    param.copy_(torch.from_numpy(np.array(arr)))


@torch.no_grad()
def from_flat(flat: Dict[str, np.ndarray], cfg: ModelConfig,
              device=None) -> Model:
    """Build the port's model from the reference's flat parameter dict."""
    model = Model(cfg, device)
    top = {"embed/emb": model.embed, "ln_f/g": model.ln_f}
    if model.lm_head is not None:
        top["lm_head/w"] = model.lm_head
    if model.mtp is not None:
        top.update({f"mtp/block/{k}": p
                    for k, p in _block_leaves(model.mtp.block).items()})
        top.update({"mtp/ln/g": model.mtp.ln, "mtp/mix/w": model.mtp.mix})
    if model.shared is not None:
        top.update({f"shared/{k}": p
                    for k, p in _block_leaves(model.shared).items()})
    if model.enc is not None:
        top["enc/ln/g"] = model.enc_ln
    if model.proj is not None:
        top.update({f"proj/{k.replace('_', '/')}": p
                    for k, p in model.proj.items()})
    for key, param in top.items():
        _copy(param, flat[key], key)
    expected = set(top)
    for si, stack in enumerate(model.stacks):
        _stacked(flat, f"stacks/{si}", stack, expected)
    if model.enc is not None:
        _stacked(flat, "enc/stack", model.enc, expected)
    extra = set(flat) - expected
    if extra:
        raise ValueError(f"checkpoint has parameters the port does not "
                         f"hold: {sorted(extra)}")
    return model


def load_score_projection(d: int, r: int, array: np.ndarray) -> None:
    """Install the reference's low-rank scoring projection (``np.asarray(
    repro.kernels.ops.score_projection(d, r))``) as the port's cached
    (d, r) projection, used by ``score_proj_dim`` and Loki on every
    device.  The reference draws it from ``jax.random``; this bridge is how
    both packages score with the same numbers."""
    kops.set_score_projection(d, r, torch.from_numpy(np.array(array)))


def restore(path: str, cfg: ModelConfig, device=None) -> Model:
    """Load a reference npz checkpoint (``training/checkpoint.py::save``)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        return from_flat({k: data[k] for k in data.files}, cfg, device)
