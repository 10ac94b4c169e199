"""Layer stack (counterpart of ``repro/models/stack.py``).

The reference scans one compiled block body over a stacked ``(repeats,
...)`` parameter axis; eager PyTorch runs a Python loop over an
``nn.ModuleList`` instead, layer ``i`` holding row ``i`` of the reference's
stacked leaves (see ``training/checkpoint.py::from_flat``).
"""
from __future__ import annotations

from typing import List, Sequence

from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import make_block
from repro_torch.serving.cache import KVCache


class Stack(nn.Module):
    def __init__(self, cfg: ModelConfig, period: Sequence[str], repeats: int,
                 device):
        super().__init__()
        self.cfg = cfg
        self.period = tuple(period)
        self.repeats = repeats
        # layer order: repeat r, period position j -> index r * len(period) + j
        self.layers = nn.ModuleList(
            make_block(cfg, kind, device) for _ in range(repeats)
            for kind in self.period)

    def init_cache(self, batch: int, cap: int) -> List[KVCache]:
        return [blk.init_cache(batch, cap) for blk in self.layers]

    def apply(self, x, pos, caches: List[KVCache], ctx):
        """Prefill chunk or decode step through every layer; caches are
        updated in place."""
        for blk, kv in zip(self.layers, caches):
            x = blk.apply(x, pos, kv, ctx)
        return x
