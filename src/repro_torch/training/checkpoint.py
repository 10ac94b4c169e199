"""Weight bridge from the reference's parameters (counterpart of
``repro/training/checkpoint.py``).

The reference flattens its parameter pytree to '/'-joined key paths
(``embed/emb``, ``ln_f/g``, ``stacks/<stack>/<period position>/wq/w``, ...)
and saves them with ``np.savez``.  Stacked layer leaves carry a leading
``(repeats, ...)`` axis; row ``r`` of period position ``j`` is the port's
layer ``r * len(period) + j`` of that stack.  Each linear weight is stored
once in the compute dtype; the embedding and norm gains stay fp32.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model

_BLOCK_LEAVES = {
    "ln1/g": lambda blk: blk.ln1,
    "ln2/g": lambda blk: blk.ln2,
    "wq/w": lambda blk: blk.wq,
    "wk/w": lambda blk: blk.wk,
    "wv/w": lambda blk: blk.wv,
    "wo/w": lambda blk: blk.wo,
    "mlp/up/w": lambda blk: blk.mlp["up"],
    "mlp/down/w": lambda blk: blk.mlp["down"],
    "mlp/gate/w": lambda blk: blk.mlp["gate"],
}


def _copy(param: torch.Tensor, arr: np.ndarray, key: str) -> None:
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{key}: shape {arr.shape} != {tuple(param.shape)}")
    param.copy_(torch.from_numpy(np.array(arr)))


@torch.no_grad()
def from_flat(flat: Dict[str, np.ndarray], cfg: ModelConfig,
              device=None) -> Model:
    """Build the port's model from the reference's flat parameter dict."""
    model = Model(cfg, device)
    expected = {"embed/emb", "ln_f/g"}
    _copy(model.embed, flat["embed/emb"], "embed/emb")
    _copy(model.ln_f, flat["ln_f/g"], "ln_f/g")
    for si, stack in enumerate(model.stacks):
        n_period = len(stack.period)
        for j in range(n_period):
            for suffix, get in _BLOCK_LEAVES.items():
                key = f"stacks/{si}/{j}/{suffix}"
                if suffix == "mlp/gate/w" and cfg.act == "gelu":
                    continue
                expected.add(key)
                arr = flat[key]
                if arr.shape[0] != stack.repeats:
                    raise ValueError(f"{key}: {arr.shape[0]} repeats, "
                                     f"expected {stack.repeats}")
                for r in range(stack.repeats):
                    _copy(get(stack.layers[r * n_period + j]), arr[r], key)
    extra = set(flat) - expected
    if extra:
        raise ValueError(f"checkpoint has parameters the port does not "
                         f"hold: {sorted(extra)}")
    return model


def restore(path: str, cfg: ModelConfig, device=None) -> Model:
    """Load a reference npz checkpoint (``training/checkpoint.py::save``)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        return from_flat({k: data[k] for k in data.files}, cfg, device)
