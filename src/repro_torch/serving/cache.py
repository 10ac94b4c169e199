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
and only read after; at batch 1 on a mesh a ``SeqCrossKV`` holds a
contiguous slice of the encoder frames, as a ``SeqKVCache`` its slots.

On a mesh a batch-1 cache may hold only a contiguous slice of its
capacity axis (a ``SeqKVCache`` or ``SeqLatentCache``, whose ``seq`` is a
``SeqShard``; a whole cache's is None): rank ``r`` of the ``data`` axis
holds slots ``[r * cap / D, (r + 1) * cap / D)``, as GSPMD lays out the
reference's ``P(..., "data", ...)``.  ``kv_write`` writes only the part
of a chunk that falls in the held slots (after the clamp, which keeps its
meaning on the whole capacity; ``latent_write`` likewise);
``kv_write_ring`` writes a sliding window's ring the same way, slot
``(start + i) % cap`` on the rank that holds it (a chunk may straddle two
ranks and wrap), with no clamp; and
``seq_full`` gathers the whole cache
where an attention needs every key (dense attention; the ranks' bytes
count under ``comm.scope("seq")``).  Selection reads the slices where
they lie (``core/plan.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.sharding import comm


class SeqShard(NamedTuple):
    """The slice of a cache's capacity axis this rank holds: slots ``lo
    .. lo + held`` of ``cap``, split over the mesh axis ``ax``."""
    ax: comm.Axis
    lo: int
    cap: int


class KVCache(NamedTuple):
    k: torch.Tensor      # (b, cap, n_kv, hd)
    v: torch.Tensor      # (b, cap, n_kv, hd)
    pos: torch.Tensor    # (b, cap) int32, -1 = empty

    @property
    def capacity(self) -> int:
        return self.k.shape[1]

    @property
    def seq(self) -> Optional[SeqShard]:
        """A whole cache: no ``SeqShard``."""
        return None


class SeqKVCache(NamedTuple):
    """A ``KVCache`` of which this rank holds the slots ``seq`` says."""
    k: torch.Tensor      # (b, held, n_kv, hd)
    v: torch.Tensor      # (b, held, n_kv, hd)
    pos: torch.Tensor    # (b, held) int32, -1 = empty
    seq: SeqShard

    @property
    def capacity(self) -> int:
        """Slots of the whole cache (every rank's)."""
        return self.seq.cap


def kv_init(batch: int, cap: int, n_kv: int, hd: int, dtype,
            device, seq_ax: Optional[comm.Axis] = None):
    """A ``KVCache`` of ``cap`` slots; with ``seq_ax`` (size D > 1,
    dividing cap) a ``SeqKVCache`` of this rank's ``cap / D`` of them."""
    held = cap if seq_ax is None or seq_ax.size == 1 else cap // seq_ax.size
    if held != cap and cap % seq_ax.size:
        raise ValueError(f"capacity {cap} does not split over "
                         f"{seq_ax.size} ranks")
    leaves = dict(
        k=torch.zeros((batch, held, n_kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, held, n_kv, hd), dtype=dtype, device=device),
        pos=torch.full((batch, held), -1, dtype=torch.int32, device=device))
    if held == cap:
        return KVCache(**leaves)
    return SeqKVCache(**leaves, seq=SeqShard(seq_ax, seq_ax.rank * held,
                                             cap))


def seq_full(cache):
    """The whole cache of a sequence-sharded one (every rank's slices
    gathered in slot order: a ``KVCache`` or a ``LatentCache``); the
    cache itself when it is whole."""
    if cache.seq is None:
        return cache
    ax = cache.seq.ax
    with comm.scope("seq"):
        if isinstance(cache, SeqLatentCache):
            return LatentCache(latent=comm.all_gather(cache.latent, ax, 1),
                               pos=comm.all_gather(cache.pos, ax, 1),
                               rank=cache.rank)
        return KVCache(k=comm.all_gather(cache.k, ax, 1),
                       v=comm.all_gather(cache.v, ax, 1),
                       pos=comm.all_gather(cache.pos, ax, 1))


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
    if cache.seq is not None:
        return _seq_write(cache, k_new, v_new, start, pos_new)
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


def _seq_write(cache: SeqKVCache, k_new, v_new, start, pos_new):
    """``kv_write`` into a sequence-sharded cache: the chunk's slots,
    clamped as on the whole capacity, that this rank holds."""
    if isinstance(start, torch.Tensor) and start.ndim > 0:
        raise ValueError("a sequence-sharded cache takes one int start "
                         "(batch-1 generate, not continuous batching)")
    b, t = k_new.shape[:2]
    start = int(start)
    if pos_new is None:
        pos_new = torch.arange(start, start + t, dtype=torch.int32,
                               device=cache.pos.device).expand(b, t)
    s = min(max(start, 0), cache.seq.cap - t)
    lo, held = cache.seq.lo, cache.k.shape[1]
    a, e = max(s, lo), min(s + t, lo + held)
    if a < e:
        cache.k[:, a - lo:e - lo] = k_new[:, a - s:e - s]
        cache.v[:, a - lo:e - lo] = v_new[:, a - s:e - s]
        cache.pos[:, a - lo:e - lo] = pos_new[:, a - s:e - s]
    return cache


def kv_write_ring(cache: KVCache, k_new, v_new, start,
                  pos_new=None) -> KVCache:
    """Append modulo capacity (a sliding-window layer's ring buffer), in
    place: token ``i`` of the chunk goes to slot ``(start + i) % cap``, so a
    chunk that wraps is one ``index_put`` per leaf.  ``start`` is an int
    only: windowed layers are not part of the paged / continuous path.
    The stored positions are ``start + [0, t)`` unless ``pos_new`` (b, t)
    overrides them.  A ``SeqKVCache`` ring takes the chunk's slots it
    holds (``_seq_write_ring``)."""
    if isinstance(start, torch.Tensor) and start.ndim > 0:
        raise ValueError("kv_write_ring takes one int start: windowed "
                         "layers are not part of the paged/continuous path")
    b, t = k_new.shape[:2]
    start = int(start)
    dev = cache.pos.device
    if pos_new is None:
        pos_new = torch.arange(start, start + t, dtype=torch.int32,
                               device=dev).expand(b, t)
    if cache.seq is not None:
        return _seq_write_ring(cache, k_new, v_new, start, pos_new)
    slots = torch.arange(start, start + t, device=dev) % cache.capacity
    cache.k[:, slots] = k_new.to(cache.k.dtype)
    cache.v[:, slots] = v_new.to(cache.v.dtype)
    cache.pos[:, slots] = pos_new.to(torch.int32)
    return cache


def _seq_write_ring(cache: SeqKVCache, k_new, v_new, start: int,
                    pos_new) -> SeqKVCache:
    """``kv_write_ring`` into a sequence-sharded ring: token ``i`` goes to
    slot ``(start + i) % cap`` of the whole ring when this rank holds it,
    with no clamp.  The held slots a chunk reaches form at most two runs
    (a chunk no longer than the ring wraps once), each one slice copy."""
    cap, lo, held = cache.seq.cap, cache.seq.lo, cache.k.shape[1]
    t = k_new.shape[1]
    i = 0
    while i < t:
        slot = (start + i) % cap
        n = min(t - i, cap - slot)          # up to the ring's end
        a, e = max(slot, lo), min(slot + n, lo + held)
        if a < e:
            src = slice(i + a - slot, i + e - slot)
            cache.k[:, a - lo:e - lo] = k_new[:, src]
            cache.v[:, a - lo:e - lo] = v_new[:, src]
            cache.pos[:, a - lo:e - lo] = pos_new[:, src]
        i += n
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

    @property
    def seq(self) -> Optional[SeqShard]:
        """A whole cache: no ``SeqShard``."""
        return None


class SeqLatentCache(NamedTuple):
    """A ``LatentCache`` of which this rank holds the slots ``seq`` says
    (batch 1, the sequence over ``data``; ``SeqKVCache``'s twin)."""
    latent: torch.Tensor   # (b, held, rank + rope)
    pos: torch.Tensor      # (b, held) int32, -1 = empty
    rank: int
    seq: SeqShard

    ckv = LatentCache.ckv
    krope = LatentCache.krope

    @property
    def capacity(self) -> int:
        """Slots of the whole cache (every rank's)."""
        return self.seq.cap


def latent_init(batch: int, cap: int, r: int, rope: int, dtype,
                device, seq_ax: Optional[comm.Axis] = None):
    """A ``LatentCache`` of ``cap`` slots; with ``seq_ax`` (size D > 1,
    dividing cap) a ``SeqLatentCache`` of this rank's ``cap / D``."""
    held = cap if seq_ax is None or seq_ax.size == 1 else cap // seq_ax.size
    if held != cap and cap % seq_ax.size:
        raise ValueError(f"capacity {cap} does not split over "
                         f"{seq_ax.size} ranks")
    leaves = dict(
        latent=torch.zeros((batch, held, r + rope), dtype=dtype,
                           device=device),
        pos=torch.full((batch, held), -1, dtype=torch.int32, device=device),
        rank=r)
    if held == cap:
        return LatentCache(**leaves)
    return SeqLatentCache(**leaves, seq=SeqShard(seq_ax, seq_ax.rank * held,
                                                 cap))


def latent_write(cache: LatentCache, ckv_new, krope_new, start,
                 pos_new=None) -> LatentCache:
    """MLA twin of ``kv_write``, in place: the same int-or-per-row
    ``start``, clamping and optional ``pos_new``; a ``SeqLatentCache``
    takes the part of the chunk in its slots."""
    b, t = ckv_new.shape[:2]
    r = cache.rank
    cap = cache.capacity
    dev = cache.pos.device
    if isinstance(start, torch.Tensor) and start.ndim == 1:
        if cache.seq is not None:
            raise ValueError("a sequence-sharded cache takes one int start "
                             "(batch-1 generate, not continuous batching)")
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
    lo, held = (0, cap) if cache.seq is None else \
        (cache.seq.lo, cache.latent.shape[1])
    a, e = max(s, lo), min(s + t, lo + held)
    if a < e:
        cache.latent[:, a - lo:e - lo, :r] = ckv_new[:, a - s:e - s]
        cache.latent[:, a - lo:e - lo, r:] = krope_new[:, a - s:e - s]
        cache.pos[:, a - lo:e - lo] = pos_new[:, a - s:e - s]
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

    @property
    def seq(self) -> Optional[SeqShard]:
        """Every frame: no ``SeqShard``."""
        return None


class SeqCrossKV(NamedTuple):
    """A ``CrossKV`` of which this rank holds the encoder frames ``seq``
    says (batch 1, the frames over ``data``, as the reference's
    ``cache_specs`` places ``cross/{k,v}``)."""
    k: torch.Tensor      # (b, held, n_kv, hd)
    v: torch.Tensor      # (b, held, n_kv, hd)
    seq: SeqShard


class CrossCache(NamedTuple):
    """A ``dec_cross`` layer's cache: the self-attention's KV cache and
    the cross-attention's ``CrossKV``."""
    kv: KVCache
    cross: CrossKV


def cross_init(batch: int, n_ctx: int, n_kv: int, hd: int, dtype,
               device, seq_ax: Optional[comm.Axis] = None):
    """A ``CrossKV`` of ``n_ctx`` frames; with ``seq_ax`` (size D > 1,
    dividing n_ctx) a ``SeqCrossKV`` of this rank's ``n_ctx / D``."""
    held = n_ctx if seq_ax is None or seq_ax.size == 1 \
        else n_ctx // seq_ax.size
    leaves = dict(
        k=torch.zeros((batch, held, n_kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, held, n_kv, hd), dtype=dtype, device=device))
    if held == n_ctx:
        return CrossKV(**leaves)
    return SeqCrossKV(**leaves, seq=SeqShard(seq_ax, seq_ax.rank * held,
                                             n_ctx))


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
