"""AdamW with a warmup-cosine schedule and global-norm clipping
(counterpart of ``repro/training/optimizer.py``, the optax semantics the
reference reproduces).

The state and the update run over a list of tensors (a model's
``parameters()``, in order).  Moments inherit each parameter's dtype (a
bf16 linear keeps bf16 moments, an fp32 gain fp32 ones); the update runs
in fp32 and is written back in the parameter's dtype, in place.  The
schedule and the bias corrections are fp32 tensors on the parameters'
device, as the reference's are fp32 arrays.

Weight decay, as the reference's ``_decay_mask``, applies to leaves of
rank >= 2.  The rank is that of the reference's leaf, which the caller
passes (``training/checkpoint.py::leaf_ranks``): every layer inside a
stack is a ``(repeats, ...)`` leaf there, so norm gains, whisper's
LayerNorm biases and Mamba2's ``a_log`` / ``d_skip`` / ``dt_bias`` /
``norm`` inside a stack ARE decayed, while ``ln_f``, the shared block's,
the MTP head's and the encoder's final gains and the projector's biases
are not.

On a mesh (``training/loop.py``) the lists are this rank's shards: the
moments sit on their parameters' shards, and the clipping norm sums each
shard's squares over the axis whose ranks hold the leaf's other pieces
(``global_norm(axes=)``), a leaf every rank holds whole counted once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence

import torch

from repro_torch.sharding import comm


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


class OptState(NamedTuple):
    step: torch.Tensor          # () int32, updates applied so far
    mu: List[torch.Tensor]      # first moments, one per parameter
    nu: List[torch.Tensor]      # second moments


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (fp32): linear warmup to ``lr``, then
    cosine decay to ``min_lr_ratio * lr`` at ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tensors: Sequence[torch.Tensor], axes=None) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in fp32.  ``axes`` (on
    a mesh): for each tensor the ``comm.Axis`` whose ranks hold its other
    pieces, or None for a tensor every rank holds whole; each piece's
    squares are summed over its axis (one fp32 all-reduce per axis), so
    every element of the whole model counts once."""
    if axes is None:
        return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                              for t in tensors))
    sums = {}
    for t, ax in zip(tensors, axes):
        sq = torch.sum(torch.square(t.float()))
        key = None if ax is None else id(ax)
        sums[key] = (ax, sq if key not in sums else sums[key][1] + sq)
    total = 0.0
    with comm.label("grad"):
        for ax, sq in sums.values():
            total = total + (sq if ax is None else comm.all_reduce(sq, ax))
    return torch.sqrt(total)


def init(params: Sequence[torch.Tensor]) -> OptState:
    if not params:
        raise ValueError("no parameters to optimise")
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=params[0].device),
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params])


def _decay_mask(rank: int) -> bool:
    """Decay matrices only: the reference's ``leaf.ndim >= 2``, on the
    rank of the reference's leaf."""
    return rank >= 2


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor],
                  grads: Sequence[Optional[torch.Tensor]], state: OptState,
                  cfg: OptimizerConfig, ranks: Sequence[int], axes=None):
    """One AdamW step: ``params`` and the moments are updated in place
    (a missing gradient counts as zeros, as the reference's gradient of an
    unused leaf).  On a mesh the parameters, gradients and moments are
    this rank's shards and ``axes`` gives each one's axis for the global
    norm (``global_norm``).  Returns (the new ``OptState``, metrics
    ``{"lr", "grad_norm"}`` as fp32 tensors; the norm is taken before
    clipping)."""
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    gnorm = global_norm(grads, axes)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf
    for p, g, m, v, rank in zip(params, grads, state.mu, state.nu, ranks):
        gf = g.float()
        if scale is not None:
            gf = gf * scale
        mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        delta = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        if _decay_mask(rank):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(mf)
        v.copy_(vf)
    return (OptState(step=step, mu=state.mu, nu=state.nu),
            {"lr": lr, "grad_norm": gnorm})
