"""Per-layer KV cache (counterpart of ``repro/serving/cache.py``).

Every slot carries its absolute position (``pos``, -1 = empty), so masks
everywhere derive from positions.  Unlike the reference, which is
functional (it returns updated arrays), ``kv_write`` writes the chunk into
the cache tensors IN PLACE: an eager PyTorch program has no buffer
donation, and a copy of the whole cache per chunk would cost its size in
memory traffic every layer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class KVCache(NamedTuple):
    k: torch.Tensor      # (b, cap, n_kv, hd)
    v: torch.Tensor      # (b, cap, n_kv, hd)
    pos: torch.Tensor    # (b, cap) int32, -1 = empty

    @property
    def capacity(self) -> int:
        return self.k.shape[1]


def kv_init(batch: int, cap: int, n_kv: int, hd: int, dtype,
            device) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, cap, n_kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, cap, n_kv, hd), dtype=dtype, device=device),
        pos=torch.full((batch, cap), -1, dtype=torch.int32, device=device))


def kv_write(cache: KVCache, k_new, v_new, start: int,
             pos_new=None) -> KVCache:
    """Write a contiguous chunk at slot ``start`` (an int), in place.
    ``pos_new`` (b, t) overrides the stored positions (pad slots -1)."""
    b, t = k_new.shape[:2]
    if pos_new is None:
        pos_new = torch.arange(start, start + t, dtype=torch.int32,
                               device=cache.pos.device).expand(b, t)
    cache.k[:, start:start + t] = k_new
    cache.v[:, start:start + t] = v_new
    cache.pos[:, start:start + t] = pos_new
    return cache
