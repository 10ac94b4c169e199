"""Per-layer KV and MLA latent caches (counterpart of
``repro/serving/cache.py``).

Every slot carries its absolute position (``pos``, -1 = empty), so masks
everywhere derive from positions.  Unlike the reference, which is
functional (it returns updated arrays), ``kv_write`` writes the chunk into
the cache tensors IN PLACE: an eager PyTorch program has no buffer
donation, and a copy of the whole cache per chunk would cost its size in
memory traffic every layer.  ``latent_write`` does the same for MLA, and
``kv_write_ring`` for a sliding-window layer's ring buffer.

``LatentCache`` keeps the reference's two leaves, the latent ``ckv`` and
the shared rope key ``krope``, as column views of ONE (b, cap, r + rope)
buffer: MLA's selection reads ``[ckv | krope]`` per layer call, and the
buffer is that concatenation already.

The recurrent families keep fixed-size states instead of a cache that
grows with the sequence: ``MambaCache`` (Mamba2's convolution tail and
SSD state), ``RWKVCache`` (RWKV6's token-shift carries and wkv state) and,
for zamba2's ``mamba_shared_attn`` layers, ``SharedAttnCache`` (the Mamba2
state beside that layer's own ``KVCache`` for the shared attention block).
``state_write`` overwrites a state's leaves in place, so a caller's cache
list stays valid across steps as it does for the KV caches.

Whisper's ``dec_cross`` layers keep a ``CrossCache``: the self-attention's
``KVCache`` beside a ``CrossKV``, the cross-attention's keys and values of
the encoder's output, written once per prompt (``Model._build_cross``)
and only read after.
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


def kv_write(cache: KVCache, k_new, v_new, start, pos_new=None) -> KVCache:
    """Write a contiguous chunk at slot ``start``, in place.  ``start`` is an
    int, or a per-row ``(b,)`` tensor under continuous batching (every
    request of a step batch writes at its own offset).  As with
    ``dynamic_update_slice`` in the reference, a start past ``cap - t`` is
    clamped so the chunk stays inside the cache (the default positions are
    still ``start + [0, t)``).  ``pos_new`` (b, t) overrides the stored
    positions (pad slots -1)."""
    b, t = k_new.shape[:2]
    cap = cache.capacity
    dev = cache.pos.device
    if isinstance(start, torch.Tensor) and start.ndim == 1:
        s = start.to(device=dev, dtype=torch.int64)
        offs = torch.arange(t, device=dev)
        if pos_new is None:
            pos_new = s[:, None] + offs
        rows = s.clamp(0, cap - t)[:, None] + offs                # (b, t)
        bi = torch.arange(b, device=dev)[:, None]
        # one index_put per leaf: no Python loop over the rows
        cache.k[bi, rows] = k_new.to(cache.k.dtype)
        cache.v[bi, rows] = v_new.to(cache.v.dtype)
        cache.pos[bi, rows] = pos_new.to(torch.int32)
        return cache
    start = int(start)
    if pos_new is None:
        pos_new = torch.arange(start, start + t, dtype=torch.int32,
                               device=dev).expand(b, t)
    s = min(max(start, 0), cap - t)
    cache.k[:, s:s + t] = k_new
    cache.v[:, s:s + t] = v_new
    cache.pos[:, s:s + t] = pos_new
    return cache


def kv_write_ring(cache: KVCache, k_new, v_new, start,
                  pos_new=None) -> KVCache:
    """Append modulo capacity (a sliding-window layer's ring buffer), in
    place: token ``i`` of the chunk goes to slot ``(start + i) % cap``, so a
    chunk that wraps is one ``index_put`` per leaf.  ``start`` is an int
    only: windowed layers are not part of the paged / continuous path.
    The stored positions are ``start + [0, t)`` unless ``pos_new`` (b, t)
    overrides them."""
    if isinstance(start, torch.Tensor) and start.ndim > 0:
        raise ValueError("kv_write_ring takes one int start: windowed "
                         "layers are not part of the paged/continuous path")
    b, t = k_new.shape[:2]
    start = int(start)
    dev = cache.pos.device
    if pos_new is None:
        pos_new = torch.arange(start, start + t, dtype=torch.int32,
                               device=dev).expand(b, t)
    slots = torch.arange(start, start + t, device=dev) % cache.capacity
    cache.k[:, slots] = k_new.to(cache.k.dtype)
    cache.v[:, slots] = v_new.to(cache.v.dtype)
    cache.pos[:, slots] = pos_new.to(torch.int32)
    return cache


class LatentCache(NamedTuple):
    """DeepSeek MLA compressed cache: per token the latent (``rank``
    columns) and the shared rope key, side by side in ``latent``."""
    latent: torch.Tensor   # (b, cap, rank + rope)
    pos: torch.Tensor      # (b, cap) int32, -1 = empty
    rank: int              # kv_lora_rank

    @property
    def ckv(self) -> torch.Tensor:
        return self.latent[..., :self.rank]

    @property
    def krope(self) -> torch.Tensor:
        return self.latent[..., self.rank:]

    @property
    def capacity(self) -> int:
        return self.latent.shape[1]


def latent_init(batch: int, cap: int, r: int, rope: int, dtype,
                device) -> LatentCache:
    return LatentCache(
        latent=torch.zeros((batch, cap, r + rope), dtype=dtype,
                           device=device),
        pos=torch.full((batch, cap), -1, dtype=torch.int32, device=device),
        rank=r)


def latent_write(cache: LatentCache, ckv_new, krope_new, start,
                 pos_new=None) -> LatentCache:
    """MLA twin of ``kv_write``, in place: the same int-or-per-row
    ``start``, clamping and optional ``pos_new``."""
    b, t = ckv_new.shape[:2]
    r = cache.rank
    cap = cache.capacity
    dev = cache.pos.device
    if isinstance(start, torch.Tensor) and start.ndim == 1:
        s = start.to(device=dev, dtype=torch.int64)
        offs = torch.arange(t, device=dev)
        if pos_new is None:
            pos_new = s[:, None] + offs
        rows = s.clamp(0, cap - t)[:, None] + offs                # (b, t)
        bi = torch.arange(b, device=dev)[:, None]
        cache.latent[bi, rows, :r] = ckv_new.to(cache.latent.dtype)
        cache.latent[bi, rows, r:] = krope_new.to(cache.latent.dtype)
        cache.pos[bi, rows] = pos_new.to(torch.int32)
        return cache
    start = int(start)
    if pos_new is None:
        pos_new = torch.arange(start, start + t, dtype=torch.int32,
                               device=dev).expand(b, t)
    s = min(max(start, 0), cap - t)
    cache.latent[:, s:s + t, :r] = ckv_new
    cache.latent[:, s:s + t, r:] = krope_new
    cache.pos[:, s:s + t] = pos_new
    return cache


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (b, d_conv - 1, di + 2 * d_state) trailing inputs
    ssd: torch.Tensor    # (b, n_heads, head_dim, d_state) fp32 state


class RWKVCache(NamedTuple):
    shift_tm: torch.Tensor  # (b, d) last normed token entering time-mix
    shift_cm: torch.Tensor  # (b, d) last normed token entering channel-mix
    wkv: torch.Tensor       # (b, n_heads, head_dim, head_dim) fp32 state


class SharedAttnCache(NamedTuple):
    """A ``mamba_shared_attn`` layer's state: its Mamba2 state and its own
    KV cache for the shared attention block."""
    mamba: MambaCache
    kv: KVCache


class CrossKV(NamedTuple):
    """Encoder-derived cross-attention keys and values (whisper), in the
    compute dtype; computed once per prompt."""
    k: torch.Tensor      # (b, n_ctx, n_kv, hd)
    v: torch.Tensor      # (b, n_ctx, n_kv, hd)


class CrossCache(NamedTuple):
    """A ``dec_cross`` layer's cache: the self-attention's KV cache and
    the cross-attention's ``CrossKV``."""
    kv: KVCache
    cross: CrossKV


def cross_init(batch: int, n_ctx: int, n_kv: int, hd: int, dtype,
               device) -> CrossKV:
    return CrossKV(
        k=torch.zeros((batch, n_ctx, n_kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, n_ctx, n_kv, hd), dtype=dtype, device=device))


def mamba_cache_init(batch: int, d_conv: int, channels: int, n_heads: int,
                     head_dim: int, d_state: int, dtype,
                     device) -> MambaCache:
    return MambaCache(
        conv=torch.zeros((batch, d_conv - 1, channels), dtype=dtype,
                         device=device),
        ssd=torch.zeros((batch, n_heads, head_dim, d_state),
                        dtype=torch.float32, device=device))


def rwkv_cache_init(batch: int, d: int, n_heads: int, head_dim: int, dtype,
                    device) -> RWKVCache:
    return RWKVCache(
        shift_tm=torch.zeros((batch, d), dtype=dtype, device=device),
        shift_cm=torch.zeros((batch, d), dtype=dtype, device=device),
        wkv=torch.zeros((batch, n_heads, head_dim, head_dim),
                        dtype=torch.float32, device=device))


def state_write(cache, new) -> None:
    """Copy a recurrent state's new leaves (a ``MambaCache`` or an
    ``RWKVCache``) into ``cache`` in place, each in its leaf's dtype."""
    for dst, src in zip(cache, new):
        dst.copy_(src)
