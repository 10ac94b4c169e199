"""Training loop (counterpart of ``repro/training/loop.py``): the training
state, one step (loss, backward, AdamW) and a simple synchronous loop.

The state is the model itself (its parameters are the trained weights,
updated in place) and the optimizer's ``OptState``.  A step runs eagerly
on the model's device; nothing is compiled.

On a mesh (a model after ``checkpoint.shard``; explicit SPMD, every rank
runs the same step on its shards) the reference's GSPMD step is written
out: each rank takes its rows of the global batch by its coordinate on
the flattened ``(pod, data)`` axis, pod major (``specs.batch_spec``), or
the whole batch when the data degree does not divide it (the
reference's ``_maybe``); the loss, the same on every rank, seeds the
backward once (``sharding/comm.py``'s convention: each rank's gradient
of a replicated tensor is its partial); the gradient of every leaf the
mesh replicates over an axis is then summed over that axis, one flat
all-reduce per axis and dtype (byte label ``grad``); AdamW updates each
rank's shards and moments, its clipping norm counting every element of
the whole model once (``optimizer.global_norm``).  A leaf without a
gradient on a mesh is an error: every leaf has one meshless.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, NamedTuple, Optional

import torch

from repro_torch.models.model import Model
from repro_torch.sharding import comm
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt


class TrainState(NamedTuple):
    model: Model
    opt: opt.OptState


def init_state(model: Model, seed: Optional[int] = 0) -> TrainState:
    """Turn the model's parameters trainable and give them fresh AdamW
    moments (on a sharded model, on its shards).  With a ``seed`` the
    weights are drawn anew first (``Model.init``: the port's own
    ``torch.Generator`` draw, not the reference's ``jax.random``; before
    ``shard``); ``seed=None`` keeps the weights the model holds (e.g.
    from ``checkpoint.from_flat``)."""
    if seed is not None:
        model.init(seed)
    model.requires_grad_(True)
    return TrainState(model=model, opt=opt.init(list(model.parameters())))


def local_batch(model: Model, batch: Dict):
    """(this rank's rows of ``batch``, the FSDP axis they are its share
    of, or None): every per-row array cut to the rank's contiguous slice,
    in rank order on the flattened ``(pod, data)`` axis; meshless, or
    when that axis does not divide the rows, the whole batch and None."""
    fax = model.fsdp
    b = batch["tokens"].shape[0]
    if fax is None or b % fax.size:
        return batch, None
    n = b // fax.size
    lo = fax.rank * n
    return {k: v[lo:lo + n] for k, v in batch.items()}, fax


def _replicated_sums(model: Model, grads) -> None:
    """Sum, in place, each gradient over the mesh axes that replicate its
    leaf (``checkpoint.leaf_axes``): one flat all-reduce per axis (or
    pair of axes) and dtype."""
    mesh = model.mesh
    sizes = {"model": comm.axis(mesh).size,
             "fsdp": model.fsdp.size if model.fsdp is not None else 1}
    groups: Dict[tuple, list] = {}
    for g, cut in zip(grads, ckpt.leaf_axes(model)):
        over = tuple(a for a in ("model", "fsdp")
                     if a not in cut and sizes[a] > 1)
        if over:
            groups.setdefault((over, g.dtype), []).append(g)
    with comm.label("grad"):
        for (over, _), gs in groups.items():
            ax = _axis(model, over)
            flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in gs]),
                                   ax)
            off = 0
            for g in gs:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()


def _axis(model: Model, names) -> comm.Axis:
    """The axis of a tuple of ``("model", "fsdp")`` names."""
    if names == ("model",):
        return comm.axis(model.mesh)
    if names == ("fsdp",):
        return model.fsdp
    return comm.world(model.mesh)


def norm_axes(model: Model):
    """Each parameter's ``optimizer.global_norm`` axis: the one whose
    ranks hold its other pieces (None: whole on every rank); None
    meshless."""
    if model.mesh is None:
        return None
    return [_axis(model, cut) if cut else None
            for cut in ckpt.leaf_axes(model)]


def value_and_grad(model: Model, batch: Dict):
    """``model.loss(batch)`` and the gradient of every parameter, in
    ``model.parameters()`` order (None for a parameter the loss does not
    reach): the counterpart of ``jax.value_and_grad(model.loss)``.  On a
    mesh: the loss of the whole batch on every rank and the gradient of
    each of this rank's shards, whole (module docstring)."""
    params = list(model.parameters())
    if model.mesh is None:
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), list(grads)
    local, rows = local_batch(model, batch)
    loss = model.loss(local, rows)
    grads = list(torch.autograd.grad(
        loss, params, grad_outputs=torch.full_like(loss,
                                                   comm.seed(model.mesh)),
        allow_unused=True))
    missing = [i for i, g in enumerate(grads) if g is None]
    if missing:
        raise RuntimeError(f"{len(missing)} parameters got no gradient on "
                           f"the mesh (indices {missing[:8]}...)")
    _replicated_sums(model, grads)
    return loss.detach(), grads


def make_train_step(model: Model, ocfg: opt.OptimizerConfig
                    ) -> Callable[[TrainState, Dict], tuple]:
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    ``loss``, ``grad_norm`` (before clipping) and ``lr`` are fp32 tensors
    on the device (reading one waits for the step)."""
    ranks = ckpt.leaf_ranks(model)
    axes = norm_axes(model)

    def train_step(state: TrainState, batch: Dict):
        loss, grads = value_and_grad(state.model, batch)
        ostate, metrics = opt.apply_updates(
            list(state.model.parameters()), grads, state.opt, ocfg, ranks,
            axes)
        metrics["loss"] = loss
        return TrainState(model=state.model, opt=ostate), metrics

    return train_step


def train(model: Model, batches: Iterable[Dict], *,
          ocfg: Optional[opt.OptimizerConfig] = None, seed: int = 0,
          steps: Optional[int] = None, log_every: int = 20,
          state: Optional[TrainState] = None, callback=None):
    """A simple synchronous loop; the reference's log lines.  Starts from
    ``state`` or from ``init_state(model, seed)``.  ``callback(i, state,
    metrics)`` runs after every step.  Returns (state, [(step, loss)] at
    the logged steps)."""
    ocfg = ocfg or opt.OptimizerConfig()
    state = state or init_state(model, seed)
    step_fn = make_train_step(model, ocfg)
    t0 = time.time()
    hist = []
    for i, batch in enumerate(batches):
        if steps is not None and i >= steps:
            break
        state, m = step_fn(state, batch)
        if i % log_every == 0 or (steps and i == steps - 1):
            loss = float(m["loss"])
            hist.append((i, loss))
            print(f"step {i:5d}  loss {loss:7.4f}  "
                  f"gnorm {float(m['grad_norm']):8.3f}  "
                  f"lr {float(m['lr']):.2e}  {time.time()-t0:6.1f}s")
        if callback is not None:
            callback(i, state, m)
    return state, hist
