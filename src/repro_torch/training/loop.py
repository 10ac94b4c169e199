"""Training loop (counterpart of ``repro/training/loop.py``): the training
state, one step (loss, backward, AdamW) and a simple synchronous loop.

The state is the model itself (its parameters are the trained weights,
updated in place) and the optimizer's ``OptState``.  A step runs eagerly
on the model's device; nothing is compiled.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, NamedTuple, Optional

import torch

from repro_torch.models.model import Model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt


class TrainState(NamedTuple):
    model: Model
    opt: opt.OptState


def init_state(model: Model, seed: Optional[int] = 0) -> TrainState:
    """Turn the model's parameters trainable and give them fresh AdamW
    moments.  With a ``seed`` the weights are drawn anew first
    (``Model.init``: the port's own ``torch.Generator`` draw, not the
    reference's ``jax.random``); ``seed=None`` keeps the weights the model
    holds (e.g. from ``checkpoint.from_flat``)."""
    if seed is not None:
        model.init(seed)
    model.requires_grad_(True)
    return TrainState(model=model, opt=opt.init(list(model.parameters())))


def value_and_grad(model: Model, batch: Dict):
    """``model.loss(batch)`` and the gradient of every parameter, in
    ``model.parameters()`` order (None for a parameter the loss does not
    reach): the counterpart of ``jax.value_and_grad(model.loss)``."""
    params = list(model.parameters())
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), list(grads)


def make_train_step(model: Model, ocfg: opt.OptimizerConfig
                    ) -> Callable[[TrainState, Dict], tuple]:
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    ``loss``, ``grad_norm`` (before clipping) and ``lr`` are fp32 tensors
    on the device (reading one waits for the step)."""
    ranks = ckpt.leaf_ranks(model)

    def train_step(state: TrainState, batch: Dict):
        loss, grads = value_and_grad(state.model, batch)
        ostate, metrics = opt.apply_updates(
            list(state.model.parameters()), grads, state.opt, ocfg, ranks)
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
