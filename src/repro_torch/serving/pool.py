"""Paged KV pool for continuous batching, with cross-request prefix caching
(counterpart of ``repro/serving/pool.py``).

The device-side store is literally ``model.init_cache(num_blocks,
block_size)``: one cache per layer whose BATCH axis is the physical-block
axis and whose capacity axis is the within-block slot axis.  An attention
layer's ``KVCache`` leaves are ``(N, block_size, n_kv, d)`` — the layout
the paged selected-attention kernel reads — and an MLA layer's
``LatentCache`` holds one ``(N, block_size, r + rope)`` latent buffer (the
reference's ``[ckv | krope]`` leaves side by side); ``pos`` is
``(N, block_size)`` for both.  Every helper below treats a layer's payload
leaves (K and V, or the latent) alike, and every view it returns keeps the
layer's cache type (a latent view keeps its ``rank``).  Every leaf keeps
the ``pos``-derived mask semantics of serving/cache.py (``pos == -1`` marks
an empty/invalid slot).  As in the reference, a model with a kind whose
cache does not decompose into blocks over time is refused: recurrent
states, cross-attention KV and sliding-window rings (which wrap at the
window, not at a block).

A request's logical cache is the concatenation of its blocks in
block-table order, materialised per step by ``gather`` (table id -1 reads
as an empty block: pos -1, zero K/V) and written back by ``scatter``
(table id -1 / untouched blocks are left alone).  Host-side bookkeeping
(free-list, per-request tables, prefix-cache indices) lives on
``PagedKVCache``; the device helpers update the pool tensors IN PLACE (an
eager program has no buffer donation; a functional copy of the pool per
step would cost its whole size in memory traffic).

Prefix caching (multi-turn chats, shared system prompts), exactly as the
reference:

  * FULL blocks of prompt KV are content-addressed by a rolling hash chain
    over their token ids (``h_i = hash(h_{i-1}, tokens_of_block_i)``).
    Tuples of ints hash deterministically, so a prompt's chain — and hence
    every prefix hit — is the reference's, bit for bit.
  * Blocks are REFCOUNTED: a cache-hit request pins a donor's prefix blocks
    into its own table read-only (the engine's scatter only writes blocks
    at/after the request's own prefill offset).
  * A block whose refcount drops to zero stays resident on an LRU list if
    it is registered (still matchable) until memory pressure evicts it into
    a fresh allocation; unregistered blocks are pos=-1-stamped and returned
    to the free list, so a recycled block never leaks a donor's KV.
  * Partially filled tail blocks are registered too; a sharer gets a
    COPY-ON-WRITE clone with the slots past the shared length stamped -1.

Hierarchical pool (``host_tier_blocks > 0``): a host-memory tier behind
the device pool, as the reference's.  Pressure eviction DEMOTES a
registered block — its content and registration move to a host slab —
instead of stamping it away; ``match_prefix`` walks the hash chain over
both tiers (``("host", slot)`` entries); ``alloc_prefix`` PROMOTES a host
match into a fresh device block, re-registered on the device.  A hash lives
in exactly one tier.  On the card:

  * a slab is one block of every layer packed into one byte row — the K and
    V rows (or the latent rows) of each layer, then each layer's positions
    — so a demotion is one gather on the device and ONE copy; the tier's
    rows are pinned host memory allocated up front (a pinned allocation
    that fails raises);
  * demotion copies device -> host with ``non_blocking`` on the compute
    stream and records an event: stream order keeps the copy ahead of the
    stamp and the writes that recycle the block, and whatever later reads
    the slab waits on that event;
  * ``stage`` (the engine's prefetch) copies host -> device on a side
    stream into a buffer from the compute stream's cached blocks, marked
    with ``record_stream`` for the side stream, and records an event that
    a promotion makes the compute stream wait on (several slots in one
    call share the buffer, the stream switch and the event).  An unstaged
    promotion copies on the compute stream (the reference's synchronous
    ``device_put``; a normal path, not a fallback); the promotions of one
    admission are written into their blocks with one copy per leaf;
  * a host row is overwritten only after the last copy out of it: the
    demotion that reuses a slot makes the compute stream wait on that
    copy's event.

On a CPU pool the rows are plain host tensors and every copy is
synchronous: device memory already is host memory, as in the reference.

On a mesh (``mesh=``, the model sharded on it by
``training/checkpoint.py::shard``) each rank's pool holds the KV heads
its layers hold: its own when the KV heads divide the ``model`` axis,
all of them otherwise, as ``sharding/specs.py::cache_specs(paged=True)``
places the pool; its block axis follows the FSDP axes ``(pod, data)``:
of ``num_blocks`` blocks, FSDP rank ``k`` of ``dp`` holds ids ``[k N /
dp, (k + 1) N / dp)`` (``rank``, ``base``, ``local_blocks``).  The host-side
bookkeeping is the same on every rank and names global ids; a request
is pinned to one rank (``alloc_prefix(rank=)``, ``rank_of_rid``), whose
share all its blocks come from, so each device helper touches only the
blocks this rank holds.  An MLA latent pool places its blocks the same
way, the latent whole on every ``model`` rank (every rank writes all of
it).  The host tier on a mesh raises the reference's error.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.serving.cache import KVCache, LatentCache

# block kinds whose caches do not decompose into pool blocks over time
# (the reference's list, with its message on refusal)
_UNSUPPORTED_KINDS = ("mamba", "mamba_shared_attn", "rwkv", "dec_cross",
                      "attn_local")

# chain-hash seed for the empty prefix (the reference's value: tuples of
# ints hash deterministically, unaffected by PYTHONHASHSEED)
_HASH_SEED = 0x51554F4B


def blocks_for_request(prompt_len: int, max_new: int, chunk_size: int,
                       block_size: int, cached_len: int = 0) -> int:
    """Blocks reserved at admission (conservative: no mid-flight OOM).

    Prefill writes whole B_CP chunks (the ragged tail is right-padded with
    pos = -1 garbage that decode later overwrites), so the reservation
    covers max(chunk-padded prefill span, prompt + max_new) slots.  With a
    prefix-cache hit the prefill chunks start at ``cached_len``, so the
    chunk grid — and its padded span — shifts with the hit."""
    span = cached_len + -(-(prompt_len - cached_len) // chunk_size) * chunk_size
    span = max(span, prompt_len + max_new)
    return -(-span // block_size)


def blocks_for_resume(kv_len: int, prompt_len: int, max_new: int,
                      chunk_size: int, block_size: int,
                      cached_len: int) -> int:
    """Blocks reserved when re-admitting a SUSPENDED request: the replay
    chunks (if any KV was evicted between suspend and resume) span from
    ``cached_len`` to ``kv_len`` on the chunk grid, and the table must
    still cover the request's full prompt + max_new token span."""
    span = kv_len if cached_len >= kv_len else \
        cached_len + -(-(kv_len - cached_len) // chunk_size) * chunk_size
    span = max(span, prompt_len + max_new)
    return -(-span // block_size)


def max_blocks_bound(prompt_len: int, max_new: int, chunk_size: int,
                     block_size: int, align: int = 0,
                     preempt: bool = False) -> int:
    """Upper bound of ``blocks_for_request`` over every admissible
    ``cached_len`` (the step geometry must cover the worst case).

    ``align`` is the prefix-hit granularity: when it is a multiple of the
    chunk size the chunk grid never shifts and the cold bound holds; token
    granularity (align=1, dense attention) can shift the last chunk to
    start at prompt_len - 1.  ``preempt``: the bound also covers the worst
    ``blocks_for_resume`` of a suspend/resume mid-decode."""
    worst = 0 if (align and align % chunk_size == 0) \
        else max(0, prompt_len - 1)
    bound = max(blocks_for_request(prompt_len, max_new, chunk_size,
                                   block_size),
                blocks_for_request(prompt_len, max_new, chunk_size,
                                   block_size, cached_len=worst))
    if preempt:
        kv = prompt_len + max(0, max_new - 1)
        worst_r = 0 if (align and align % chunk_size == 0) \
            else max(0, kv - 1)
        bound = max(bound,
                    blocks_for_resume(kv, prompt_len, max_new, chunk_size,
                                      block_size, 0),
                    blocks_for_resume(kv, prompt_len, max_new, chunk_size,
                                      block_size, worst_r))
    return bound


def _chain_hashes(tokens: np.ndarray, block_size: int) -> List[int]:
    """Rolling hash per FULL block: identity covers the whole prefix."""
    h, out = _HASH_SEED, []
    for i in range(len(tokens) // block_size):
        h = hash((h, tuple(map(int, tokens[i * block_size:
                                           (i + 1) * block_size]))))
        out.append(h)
    return out


def _layers(data) -> Iterator[Union[KVCache, LatentCache]]:
    """Every layer's cache of a pool (or gathered view), in model order."""
    for stack in data:
        yield from stack


def _payload(c) -> List[torch.Tensor]:
    """A layer cache's payload leaves: K and V, or MLA's latent buffer."""
    return [c.latent] if isinstance(c, LatentCache) else [c.k, c.v]


def _leaves(c) -> List[torch.Tensor]:
    """Every tensor leaf of a layer cache: its payload, then ``pos``."""
    return _payload(c) + [c.pos]


def _like(c, f):
    """A cache of ``c``'s type whose tensors are ``f(leaf, fill)``, with
    ``fill`` what an empty slot of that leaf reads (-1 positions, zero
    payload)."""
    if isinstance(c, LatentCache):
        return LatentCache(latent=f(c.latent, 0), pos=f(c.pos, -1),
                           rank=c.rank)
    return KVCache(k=f(c.k, 0), v=f(c.v, 0), pos=f(c.pos, -1))


def _slab_leaves(data) -> List[torch.Tensor]:
    """A slab's leaves in their packed order: every layer's payload (K and
    V, or the latent), then every layer's positions (so each leaf starts on
    an aligned byte offset: the int32 rows follow payload rows of an even
    number of bytes)."""
    layers = list(_layers(data))
    return [x for c in layers for x in _payload(c)] + \
        [c.pos for c in layers]


def _slab_nbytes(data) -> int:
    """Bytes of one block of every layer: one host slab."""
    return sum(leaf[0].numel() * leaf.element_size()
               for leaf in _slab_leaves(data))


class HostTier:
    """Slot-addressed host store of demoted block slabs + LRU.

    Storage only: registrations and the cross-tier hash indices stay on
    ``PagedKVCache`` (beside the device tier's) so ``check_invariants``
    covers both tiers in one place.  The pool drives eviction: ``oldest``
    names the victim, the pool unregisters it, then ``drop`` frees the
    slot.  The rows are allocated up front, pinned when the pool is on the
    card.  ``written`` / ``read`` hold the event of the last copy into and
    out of each slot (card only)."""

    def __init__(self, capacity: int, nbytes: int, device: torch.device):
        self.capacity = int(capacity)
        self.device = device
        self.store = torch.empty((self.capacity, int(nbytes)),
                                 dtype=torch.uint8,
                                 pin_memory=device.type == "cuda")
        self._free: List[int] = list(range(self.capacity))
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.written: Dict[int, "torch.cuda.Event"] = {}
        self.read: Dict[int, "torch.cuda.Event"] = {}

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def num_free(self) -> int:
        return len(self._free)

    def oldest(self) -> int:
        return next(iter(self._lru))

    def put(self) -> int:
        """Take a free slot (caller ensured one) at the MRU end."""
        slot = self._free.pop()
        self._lru[slot] = None
        return slot

    def row(self, slot: int) -> torch.Tensor:
        return self.store[slot]

    def write(self, slot: int, data, b: int) -> None:
        """Copy block ``b`` of every layer of ``data`` into ``slot``: one
        gather into a packed buffer, then one copy.  On the card the copy
        is asynchronous on the current stream, after any copy still reading
        the slot's previous slab, and its event is recorded."""
        parts = [leaf[b].reshape(-1).view(torch.uint8)
                 for leaf in _slab_leaves(data)]
        if self.device.type != "cuda":
            torch.cat(parts, out=self.store[slot])
            return
        cur = torch.cuda.current_stream(self.device)
        busy = self.read.pop(slot, None)
        if busy is not None:
            cur.wait_event(busy)
        self.store[slot].copy_(torch.cat(parts), non_blocking=True)
        done = torch.cuda.Event()
        done.record(cur)
        self.written[slot] = done

    def touch(self, slot: int) -> None:
        self._lru.move_to_end(slot)

    def drop(self, slot: int) -> None:
        del self._lru[slot]
        self._free.append(slot)


def _check_pool_mesh(model, mesh, num_blocks: int, block_size: int) -> int:
    """A pool on ``mesh``: the model must be sharded on it, and each
    layer's held KV heads must be what ``cache_specs(paged=True)`` places
    on this rank (an MLA latent: never split over ``model``, every rank
    holds it whole).  Returns the ranks its block axis splits over."""
    from repro_torch.sharding import specs
    cfg = model.cfg
    if model.mesh is not mesh:
        raise ValueError("shard the model on this mesh first "
                         "(training/checkpoint.py::shard; Engine(mesh=) "
                         "does)")
    msize = specs.mesh_shape(mesh).get("model", 1)
    place = specs.payload_specs(specs.cache_specs(cfg, specs.kv_cache_shapes(
        cfg, num_blocks, block_size), mesh, paged=True))
    dp = specs._axes_size(mesh, place["stacks/0/0"][1])
    for si, stack in enumerate(model.stacks):
        for i, blk in enumerate(stack.layers):
            spec = place[f"stacks/{si}/{i % len(stack.period)}"]
            if spec[1:3] != place["stacks/0/0"][1:3]:
                raise ValueError(f"the pool's layers place their blocks "
                                 f"differently: {spec}")
            if len(spec) == 4:              # an MLA latent (R, N, bs, r)
                if "model" in spec:
                    raise ValueError(f"an MLA latent placed over model: "
                                     f"{spec}")
                continue
            want = cfg.n_kv_heads // msize if spec[3] == "model" \
                else cfg.n_kv_heads
            if blk.n_kv != want:
                raise ValueError(f"layer holds {blk.n_kv} KV heads, the "
                                 f"pool's placement {spec} wants {want}")
    return dp


class PagedKVCache:
    """Fixed-size-block KV pool + per-request block tables + free-list +
    content-addressed prefix cache (refcounts, LRU eviction, COW tails)."""

    def __init__(self, model, num_blocks: int, block_size: int, mesh=None,
                 host_tier_blocks: int = 0):
        kinds = [k for s in model.stacks for k in s.period]
        bad = sorted(set(k for k in kinds if k in _UNSUPPORTED_KINDS))
        if bad:
            raise ValueError(
                f"paged KV pool supports attention/MLA caches only; "
                f"model has unsupported block kinds {bad}")
        if model.cfg.family == "vlm":
            raise ValueError("paged KV pool does not support VLM frontends")
        if host_tier_blocks and mesh is not None:
            raise ValueError(
                "host tier + mesh is not supported yet: demotion would "
                "have to gather a sharded block slab per eviction")
        self.dp = 1 if mesh is None else \
            _check_pool_mesh(model, mesh, int(num_blocks), int(block_size))
        self.model = model
        self.mesh = mesh
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # this rank's share of the block axis (module docstring)
        self.local_blocks = self.num_blocks // self.dp
        self.rank = 0 if self.dp == 1 else model.fsdp.rank
        self.base = self.rank * self.local_blocks
        self.data = model.init_cache(self.local_blocks, self.block_size)
        self._free: List[int] = list(range(self.num_blocks))
        self._tables: Dict[int, List[int]] = {}
        self._rank: Dict[int, int] = {}             # rid -> its FSDP rank
        # ---- prefix cache state ----
        self._ref: Dict[int, int] = {}              # block -> live refcount
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # evictable
        self._reg: Dict[int, Tuple] = {}            # block -> registration
        self._full: Dict[int, int] = {}             # chain hash -> block
        self._tail: Dict[int, int] = {}             # prefix hash -> block
        # ---- host tier (module docstring) ----
        self.host: Optional[HostTier] = (
            HostTier(host_tier_blocks, _slab_nbytes(self.data), self.device)
            if host_tier_blocks else None)
        self._h_reg: Dict[int, Tuple] = {}          # host slot -> registration
        self._h_full: Dict[int, int] = {}           # chain hash -> host slot
        self._h_tail: Dict[int, int] = {}           # prefix hash -> host slot
        # host slot -> (device buffer, event of its H2D copy or None)
        self._staged: Dict[int, Tuple] = {}
        # the staging stream, made up front: creating it inside a step
        # would hold the host while the first copies run
        self._side: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(self.device)
            if self.host is not None and self.device.type == "cuda"
            else None)
        # ---- counters (Engine.stats / ServeResult.prefix) ----
        self.evictions = 0
        self.cow_copies = 0
        self.lookups = 0
        self.hit_requests = 0
        self.hit_tokens = 0
        self.prompt_tokens = 0
        self.demoted = 0
        self.promoted = 0
        self.host_evictions = 0                     # host-tier cache LOSS
        self.staged_used = 0                        # promotions from staging

    @property
    def device(self) -> torch.device:
        return next(_layers(self.data)).pos.device


    # ---- free-list bookkeeping ------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_evictable(self) -> int:
        return len(self._lru)

    @property
    def num_cached(self) -> int:
        """Registered (matchable) blocks, live or evictable."""
        return len(self._reg)

    def rank_of(self, b: int) -> int:
        """The FSDP rank that holds block ``b``."""
        return b // self.local_blocks

    def rank_of_rid(self, rid: int) -> int:
        """The FSDP rank request ``rid``'s blocks came from."""
        return self._rank.get(rid, 0)

    def _on(self, rank: Optional[int], blocks) -> List[int]:
        """``blocks`` held by ``rank`` (all of them for None)."""
        return list(blocks) if rank is None else \
            [b for b in blocks if self.rank_of(b) == rank]

    def num_free_on(self, rank: Optional[int] = None) -> int:
        if rank is None:
            return len(self._free)
        return len(self._on(rank, self._free))

    def can_alloc(self, n: int, exclude: Sequence[int] = (),
                  rank: Optional[int] = None) -> bool:
        """Can ``n`` FRESH blocks be produced (free list + LRU eviction),
        without evicting any block in ``exclude``?  ``rank``: from that
        FSDP rank's share only."""
        if rank is None:
            lru = len(self._lru) - sum(1 for b in exclude if b in self._lru)
        else:
            lru = len(self._on(rank, self._lru)) - sum(
                1 for b in exclude
                if b in self._lru and self.rank_of(b) == rank)
        return n <= self.num_free_on(rank) + lru

    def alloc(self, rid: int, n: int) -> List[int]:
        return self.alloc_prefix(rid, n)

    def alloc_prefix(self, rid: int, n_total: int,
                     shared: Sequence = (),
                     cow: Optional[Tuple] = None,
                     rank: Optional[int] = None) -> List[int]:
        """Build request ``rid``'s table: ``shared`` prefix entries in
        logical order followed by the remaining fresh blocks.  An entry is
        a physical device block id (refcount-pinned read-only) or ``("host",
        slot)``, a host-tier block PROMOTED here into a fresh device block
        (from its staged copy when the engine prefetched it) and
        re-registered on the device under its hash; so only device entries
        come for free, promotions draw fresh blocks.

        ``cow = (src, keep)`` initialises the first post-prefix fresh block
        as a copy of ``src`` — a device block id or ``("host", slot)`` —
        with slots >= ``keep`` invalidated (shared partial tail).  A host
        COW source is copied, not consumed: the host copy stays
        matchable.

        ``rank`` pins the request to one FSDP rank of a split pool: its
        fresh blocks come from that rank's share, and ``shared`` / ``cow``
        must lie there too."""
        if rid in self._tables:
            raise RuntimeError(f"request {rid} already holds blocks")
        if rank is not None and any(
                self.rank_of(b) != rank for b in
                list(shared) + ([cow[0]] if cow else [])
                if not isinstance(b, tuple)):
            raise RuntimeError(f"request {rid}'s hit lies off rank {rank}")
        dev_shared = [e for e in shared if not isinstance(e, tuple)]
        promote = [e[1] for e in shared if isinstance(e, tuple)]
        cow_host = cow is not None and isinstance(cow[0], tuple)
        n_fresh = n_total - len(dev_shared)
        protect = dev_shared + ([cow[0]] if cow and not cow_host else [])
        if not self.can_alloc(n_fresh, exclude=protect, rank=rank):
            raise RuntimeError(
                f"pool exhausted: need {n_fresh} fresh blocks, "
                f"{len(self._free)} free + {len(self._lru)} evictable")
        # pin the shared prefix FIRST so fresh allocation cannot evict it
        for b in dev_shared:
            self._pin(b)
        # take the host sources BEFORE fresh allocation: taking fresh
        # blocks can demote device blocks into the host tier, and a host
        # eviction that causes must not hit a slot about to be promoted
        promo = [self._take_host(s) for s in promote]   # [(buffer, reg)]
        cow_buf = self._peek_host(cow[0][1]) if cow_host else None
        fresh, stale = [], []
        for _ in range(n_fresh):
            b, was_cached = self._take_fresh(protect, rank)
            if was_cached:
                stale.append(b)
            fresh.append(b)
            self._ref[b] = 1
        self._stamp(stale)                 # evicted content is stale
        # the table in logical order, promotions drawing fresh blocks
        it = iter(fresh)
        table, promo_dst = [], []
        for e in shared:
            if isinstance(e, tuple):
                promo_dst.append(next(it))
                table.append(promo_dst[-1])
            else:
                table.append(e)
        rest = list(it)
        _write_blocks(self.data, [buf for buf, _ in promo], promo_dst)
        for (_, reg), dst in zip(promo, promo_dst):
            self._reg[dst] = reg           # re-registered on the DEVICE
            index = self._full if reg[0] == "full" else self._tail
            index[reg[1]] = dst
            self.promoted += 1
        if cow is not None:
            src, keep = cow
            if cow_host:
                _write_blocks(self.data, [cow_buf], [rest[0]])
                for c in _layers(self.data):
                    c.pos[rest[0], keep:] = -1
            else:
                if src not in self._ref and src not in self._lru:
                    raise RuntimeError(f"COW source block {src} not resident")
                if self.rank_of(rest[0]) == self.rank:    # src's rank too
                    _cow_block(self.data, src - self.base,
                               rest[0] - self.base, keep)
            self.cow_copies += 1
        self._tables[rid] = table + rest
        if self.dp > 1:
            self._rank[rid] = 0 if rank is None else rank
        return self._tables[rid]

    def free(self, rid: int) -> List[int]:
        """Release a request's blocks.  Registered blocks stay resident on
        the LRU list (matchable until evicted); the rest are pos=-1-stamped
        so no stale KV can leak into a later allocation.  Returns the
        blocks that landed on the LRU list (the suspend path demotes
        exactly those)."""
        blocks = self._tables.pop(rid)   # KeyError on double free
        self._rank.pop(rid, None)
        stale, retained = [], []
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                if b in self._reg:
                    self._lru[b] = None          # MRU end, content kept
                    retained.append(b)
                else:
                    stale.append(b)
                    self._free.append(b)
        self._stamp(stale)
        return retained

    def table(self, rid: int) -> List[int]:
        return self._tables[rid]

    def table_array(self, rids: Sequence[int], rows: int,
                    max_blocks: int,
                    at: Optional[Sequence[int]] = None) -> np.ndarray:
        """(rows, max_blocks) int32 block table, -1 padded (empty block):
        ``rids[i]``'s blocks in row ``at[i]`` (default ``i``).  Rows no
        request takes are idle (all -1)."""
        tab = np.full((rows, max_blocks), -1, np.int32)
        for i, rid in zip(range(len(rids)) if at is None else at, rids):
            blocks = self._tables[rid]
            tab[i, :len(blocks)] = blocks
        return tab

    # ---- prefix cache ----------------------------------------------------
    def match_prefix(self, tokens: np.ndarray,
                     chain: Optional[List[int]] = None
                     ) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest cached prefix of ``tokens``: (matched full blocks, tail).
        Each full-block entry is a device block id or, with the host tier
        on, ``("host", slot)`` for a demoted block (a hash lives in one
        tier only).  ``tail = (src, n_common)`` if a registered partial
        tail (same encoding) extends the matched full-block prefix by
        ``n_common`` shared tokens.  ``chain`` is the precomputed
        ``_chain_hashes`` of ``tokens``."""
        toks = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        if chain is None:
            chain = _chain_hashes(toks, bs)
        h, fulls = _HASH_SEED, []
        for h2 in chain:
            b = self._full.get(h2)
            if b is None and self.host is not None:
                s = self._h_full.get(h2)
                if s is not None:
                    b = ("host", s)
                    self.host.touch(s)
            if b is None:
                break
            fulls.append(b)
            h = h2
        tail = None
        tb = self._tail.get(h)
        t_toks = self._reg[tb][2] if tb is not None else None
        if tb is None and self.host is not None:
            s = self._h_tail.get(h)
            if s is not None:
                tb = ("host", s)
                t_toks = self._h_reg[s][2]
                self.host.touch(s)
        if tb is not None:
            rem = toks[len(fulls) * bs:]
            m = 0
            while m < min(len(rem), len(t_toks)) and \
                    int(rem[m]) == t_toks[m]:
                m += 1
            if m > 0:
                tail = (tb, m)
        return fulls, tail

    def register_prefix(self, rid: int, tokens: np.ndarray,
                        chain: Optional[List[int]] = None) -> None:
        """Content-address request ``rid``'s prompt blocks (call once the
        prompt is fully prefilled)."""
        toks = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        table = self._tables[rid]
        if chain is None:
            chain = _chain_hashes(toks, bs)
        h = _HASH_SEED
        for i, h2 in enumerate(chain):
            h = h2
            b = table[i]
            if b in self._reg or h in self._full:
                continue                 # shared / duplicate content
            self._reg[b] = ("full", h)
            self._full[h] = b
        rem = len(toks) % bs
        if rem:
            tb = table[len(toks) // bs]
            if tb not in self._reg and h not in self._tail:
                self._reg[tb] = ("tail", h,
                                 tuple(map(int, toks[len(toks) - rem:])))
                self._tail[h] = tb
        self._drop_host_duplicates()

    def register_suspend(self, rid: int, tokens: np.ndarray) -> None:
        """Content-address request ``rid``'s blocks over ``tokens`` — the
        prompt PLUS the generated tokens whose KV the cache holds — before
        suspension releases them, UPGRADING stale registrations (decode may
        have grown a registered partial tail or filled it into a full
        block)."""
        toks = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        table = self._tables[rid]
        chain = _chain_hashes(toks, bs)
        h = _HASH_SEED
        for i, h2 in enumerate(chain):
            h = h2
            b = table[i]
            reg = self._reg.get(b)
            if reg is not None and reg[0] == "tail":
                # decode filled this once-partial tail into a full block
                self._unregister(b)
                reg = None
            if reg is not None or h in self._full:
                continue                 # shared / duplicate content
            self._reg[b] = ("full", h)
            self._full[h] = b
        rem = len(toks) % bs
        if rem:
            tb = table[len(toks) // bs]
            t_toks = tuple(map(int, toks[len(toks) - rem:]))
            cur = self._reg.get(tb)
            if cur is not None and cur[0] == "tail" and cur[1] == h \
                    and self._tail.get(h) == tb:
                if len(cur[2]) < rem:    # decode extended the tail
                    self._reg[tb] = ("tail", h, t_toks)
            elif cur is None and h not in self._tail:
                self._reg[tb] = ("tail", h, t_toks)
                self._tail[h] = tb
        self._drop_host_duplicates()

    def _drop_host_duplicates(self) -> None:
        """Single residency: a cold admit can re-prefill and register
        content whose demoted copy still sits on the host tier; the host
        copy goes (the device copy is the one sharers should pin)."""
        if self.host is None:
            return
        for idx, hmap in ((self._full, self._h_full),
                          (self._tail, self._h_tail)):
            for hh in [hh for hh in hmap if hh in idx]:
                self._h_unregister(hmap[hh])

    def suspend(self, rid: int, tokens: np.ndarray) -> Tuple[int, int]:
        """Preemption: release request ``rid``'s blocks with their KV kept
        matchable for resume (content-registered, then freed).  With the
        host tier on, the blocks this request owned alone are demoted at
        once (suspension exists to free device blocks now), while blocks
        shared with live requests stay pinned on the device; without one
        they park on the LRU list (pressure in between is real cache loss
        and forces a replay).  Returns (blocks released, blocks
        demoted)."""
        self.register_suspend(rid, tokens)
        n_total = len(self._tables[rid])
        retained = self.free(rid)
        demoted = 0
        if self.host is not None:
            stale = []
            for b in retained:
                if b in self._lru and b in self._reg:
                    del self._lru[b]
                    self._demote(b)
                    stale.append(b)
                    self._free.append(b)
                    demoted += 1
            self._stamp(stale)
        return n_total, demoted

    def stage(self, *slots: int) -> int:
        """Start the H2D copies of host slots ``slots`` ahead of their
        promotion (the engine's prefetch calls this while a step is
        dispatched).  On the card the copies run back to back on a side
        stream, each after its slot's own demotion copy, into one buffer
        from the compute stream's cached blocks (a fresh device allocation
        between the two streams' commands would stop them running
        concurrently; the side stream first waits for the compute work
        queued so far, which may still use those blocks), and record one
        event that a promotion makes the compute stream wait on.  Slots
        already staged are skipped; returns the copies started."""
        if self.host is None:
            return 0
        slots = [s for s in dict.fromkeys(slots) if s not in self._staged]
        if not slots:
            return 0
        dev = self.device
        if dev.type != "cuda":
            for slot in slots:
                self._staged[slot] = (self.host.row(slot).clone(), None)
            return len(slots)
        side = self._side
        buf = torch.empty((len(slots), self.host.store.shape[1]),
                          dtype=torch.uint8, device=dev)
        buf.record_stream(side)
        side.wait_stream(torch.cuda.current_stream(dev))
        done = torch.cuda.Event()
        with torch.cuda.stream(side):
            for i, slot in enumerate(slots):
                written = self.host.written.get(slot)
                if written is not None:
                    side.wait_event(written)
                buf[i].copy_(self.host.row(slot), non_blocking=True)
            done.record(side)
        for i, slot in enumerate(slots):
            self.host.read[slot] = done
            self._staged[slot] = (buf[i], done)
        return len(slots)

    # ---- internals -------------------------------------------------------
    def _pin(self, b: int) -> None:
        """Refcount++ a resident block (pulling it off the LRU list)."""
        if b not in self._ref:
            if b not in self._lru:
                raise RuntimeError(f"block {b} not resident, cannot share")
            del self._lru[b]
            self._ref[b] = 1
        else:
            self._ref[b] += 1

    def _take_fresh(self, protect: Sequence[int],
                    rank: Optional[int] = None) -> Tuple[int, bool]:
        """One fresh block (of FSDP rank ``rank``'s share when given):
        free list first, then LRU eviction (the evicted block loses its
        cache entry).  Returns (block, needs stamping) — free-list blocks
        were stamped when freed."""
        for i in range(len(self._free) - 1, -1, -1):     # the newest first
            if rank is None or self.rank_of(self._free[i]) == rank:
                return self._free.pop(i), False
        for b in self._lru:                        # oldest first
            if b not in protect and (rank is None
                                     or self.rank_of(b) == rank):
                del self._lru[b]
                if self.host is not None:
                    self._demote(b)
                else:
                    self._unregister(b)
                self.evictions += 1
                return b, True
        raise RuntimeError("pool exhausted: no evictable block")

    def _unregister(self, b: int) -> None:
        reg = self._reg.pop(b)
        index = self._full if reg[0] == "full" else self._tail
        if index.get(reg[1]) == b:
            del index[reg[1]]

    # ---- host tier internals --------------------------------------------
    def _demote(self, b: int) -> None:
        """Move an evicted registered block into the host tier: copy its
        slab out (dispatched BEFORE the caller stamps and recycles the
        block: stream order keeps the copy first) and move the hash
        registration across tiers.  The host tier's own eviction (its
        oldest slot) is real cache loss."""
        reg = self._reg.pop(b)
        index = self._full if reg[0] == "full" else self._tail
        if index.get(reg[1]) != b:
            return                          # duplicate content; nothing owned
        del index[reg[1]]
        hmap = self._h_full if reg[0] == "full" else self._h_tail
        old = hmap.get(reg[1])
        if old is not None:                 # stale host copy of the same hash
            self._h_unregister(old)
        if self.host.num_free == 0:
            self._h_unregister(self.host.oldest())
            self.host_evictions += 1
        slot = self.host.put()
        self.host.write(slot, self.data, b)
        self._h_reg[slot] = reg
        hmap[reg[1]] = slot
        self.demoted += 1

    def _h_unregister(self, slot: int) -> None:
        reg = self._h_reg.pop(slot)
        index = self._h_full if reg[0] == "full" else self._h_tail
        if index.get(reg[1]) == slot:
            del index[reg[1]]
        self.host.drop(slot)
        self._staged.pop(slot, None)

    def _device_copy(self, slot: int) -> torch.Tensor:
        """Slot ``slot``'s slab on the pool's device, ready for the compute
        stream: its staged copy (the stream waits on the copy's event, and
        the buffer is marked in use there) or a copy made now on the
        compute stream, which orders it after the slot's demotion."""
        staged = self._staged.get(slot)
        if staged is None:
            row = self.host.row(slot)
            return torch.empty(row.shape, dtype=torch.uint8,
                               device=self.device).copy_(row,
                                                         non_blocking=True)
        buf, done = staged
        self.staged_used += 1
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
        return buf

    def _take_host(self, slot: int) -> Tuple[torch.Tensor, Tuple]:
        """Consume host slot ``slot`` for promotion: (its slab on the
        device, its registration)."""
        reg = self._h_reg.pop(slot)
        index = self._h_full if reg[0] == "full" else self._h_tail
        if index.get(reg[1]) == slot:
            del index[reg[1]]
        buf = self._device_copy(slot)
        self._staged.pop(slot, None)
        self.host.drop(slot)
        return buf, reg

    def _peek_host(self, slot: int) -> torch.Tensor:
        """Slot ``slot``'s slab on the device WITHOUT consuming it (a COW
        tail source: the sharer's clone is private, so the host copy stays
        matchable, staged copy included)."""
        self.host.touch(slot)
        return self._device_copy(slot)

    def _stamp(self, blocks: List[int]) -> None:
        """pos=-1-stamp ``blocks`` on device: recycled blocks must read as
        empty (a donor's stale positions would pass the validity masks)."""
        mine = [b - self.base for b in self._on(self.rank, blocks)]
        if mine:
            _stamp_blocks(self.data, torch.as_tensor(mine,
                                                     device=self.device))

    def check_invariants(self) -> None:
        """No block leaked, double-allocated, double-freed, or in two of
        {allocated, free, LRU}; refcounts match table membership; the hash
        indices and registrations agree."""
        refs: Dict[int, int] = {}
        for t in self._tables.values():
            assert len(set(t)) == len(t), "block twice in one table"
            for b in t:
                refs[b] = refs.get(b, 0) + 1
        assert refs == self._ref, "refcounts out of sync with tables"
        held = set(refs)
        free, lru = set(self._free), set(self._lru)
        assert len(self._free) == len(free), "block double-freed"
        assert not (held & free), "allocated block on the free list"
        assert not (held & lru), "allocated block on the LRU list"
        assert not (free & lru), "block both free and evictable"
        assert sorted(held | free | lru) == list(range(self.num_blocks)), \
            "block leaked or invented"
        for h, b in self._full.items():
            assert self._reg.get(b, (None, None))[:2] == ("full", h)
        for h, b in self._tail.items():
            r = self._reg.get(b)
            assert r is not None and r[0] == "tail" and r[1] == h
        for b in self._reg:
            assert b in held or b in lru, "registered block recycled"
        if self.host is not None:
            slots = set(self._h_reg)
            assert slots == set(self.host._lru), \
                "host registrations out of sync with stored slabs"
            assert len(slots) + self.host.num_free == self.host.capacity, \
                "host slot leaked or invented"
            assert not (slots & set(self.host._free)), \
                "host slot both stored and free"
            for h, s in self._h_full.items():
                assert self._h_reg.get(s, (None, None))[:2] == ("full", h)
            for h, s in self._h_tail.items():
                r = self._h_reg.get(s)
                assert r is not None and r[0] == "tail" and r[1] == h
            assert not (set(self._h_full) & set(self._full)), \
                "full-block hash resident in both tiers"
            assert not (set(self._h_tail) & set(self._tail)), \
                "tail hash resident in both tiers"
            assert set(self._staged) <= slots, "staged buffer for freed slot"


# ---------------------------------------------------------------------------
# device helpers (in place on the pool tensors)
# ---------------------------------------------------------------------------

def _stamp_blocks(data, ids: torch.Tensor) -> None:
    """Set pos = -1 across blocks ``ids``.  Only positions are stamped; KV
    payloads stay in place — the position masks make them unreadable."""
    for c in _layers(data):
        c.pos.index_fill_(0, ids, -1)


def _cow_block(data, src: int, dst: int, keep: int) -> None:
    """Copy block ``src`` into ``dst`` (copy-on-write of a shared partial
    tail), invalidating slots >= ``keep``: those hold the donor's private
    suffix/decode KV, which the sharer must not see."""
    for c in _layers(data):
        for leaf in _leaves(c):
            leaf[dst] = leaf[src]
        c.pos[dst, keep:] = -1


def _write_blocks(data, bufs: List[torch.Tensor], dsts: List[int]) -> None:
    """Unpack slabs (packed byte rows on the pool's device) into blocks
    ``dsts`` of every layer — the H2D half of promotion: one copy per leaf
    for all the blocks, not one per leaf and block."""
    if not bufs:
        return
    src = bufs[0][None] if len(bufs) == 1 else torch.stack(bufs)
    ids = torch.as_tensor(dsts, device=src.device)
    off = 0
    for leaf in _slab_leaves(data):
        n = leaf[0].numel() * leaf.element_size()
        rows = src[:, off:off + n].view(leaf.dtype)
        leaf.index_copy_(0, ids, rows.view(len(bufs), *leaf.shape[1:]))
        off += n


# ---------------------------------------------------------------------------
# gather / scatter (the engine's step functions call these around the model)
# ---------------------------------------------------------------------------

def _host_table(table) -> np.ndarray:
    """Block tables and write masks are built on the host; reading them
    there keeps every index decision off the device (no sync per step)."""
    if isinstance(table, torch.Tensor):
        table = table.cpu().numpy()
    return np.asarray(table)


def gather(data, table, num_blocks: int, block_size: int):
    """Materialise per-request linear caches from the pool.

    table: (b, max_nb) int32 physical block ids, -1 = empty (host array).
    Returns the pool's nested structure of cache views (each layer's type:
    ``KVCache`` or ``LatentCache``) with leaves (b, max_nb * block_size,
    ...) — a standard linear cache — where empty blocks read as pos = -1
    and a zero payload, so the position-mask machinery
    needs no special case.  One ``index_select`` per leaf, plus a fill of
    the empty blocks only; the work runs under a ``pool_gather`` profiler
    range (``pool_scatter`` for ``scatter``), the reference's named
    scopes."""
    tab = _host_table(table)
    b, nb = tab.shape
    flat = tab.reshape(-1)
    holes = np.nonzero(flat < 0)[0]
    dev = next(_layers(data)).pos.device
    idx = torch.as_tensor(np.maximum(flat, 0).astype(np.int64), device=dev)
    hole_idx = torch.as_tensor(holes, device=dev) if holes.size else None

    def g(leaf, fill):
        out = leaf.index_select(0, idx)
        if hole_idx is not None:
            out.index_fill_(0, hole_idx, fill)
        return out.reshape(b, nb * block_size, *leaf.shape[2:])

    with torch.profiler.record_function("pool_gather"):
        return [[_like(c, g) for c in stack] for stack in data]


def gather_blocks(data, table, block_ids, num_blocks: int, block_size: int):
    """Materialise only SELECTED logical blocks of each request: a sub-view
    of ``gather`` driven by per-request logical block indices (b, nb_sel),
    -1 = padding (reads as an empty block)."""
    tab = _host_table(table)
    ids = _host_table(block_ids)
    sub = np.take_along_axis(tab, np.maximum(ids, 0), axis=1)
    sub = np.where(ids >= 0, sub, -1)
    return gather(data, sub, num_blocks, block_size)


def scatter(data, gathered, table, touched, num_blocks: int,
            block_size: int) -> None:
    """Write gathered views back into the pool, in place.

    ``touched`` (b, max_nb) bool limits the write to blocks the step
    actually modified; untouched and null (-1) table entries are not
    written.  Prefix-shared blocks are safe behind this mask: a sharer's
    writes start at its own prefill offset, so its touched window never
    covers the shared prefix."""
    tab = _host_table(table)
    b, nb = tab.shape
    flat = tab.reshape(-1)
    src = np.nonzero((flat >= 0) & _host_table(touched).reshape(-1))[0]
    if not src.size:
        return
    dev = next(_layers(data)).pos.device
    src_i = torch.as_tensor(src, device=dev)
    dst_i = torch.as_tensor(flat[src].astype(np.int64), device=dev)
    with torch.profiler.record_function("pool_scatter"):
        for c, gc in zip(_layers(data), _layers(gathered)):
            for pool_leaf, gath_leaf in zip(_leaves(c), _leaves(gc)):
                blocks = gath_leaf.reshape(b * nb, block_size,
                                           *gath_leaf.shape[2:])
                pool_leaf.index_copy_(0, dst_i,
                                      blocks.index_select(0, src_i))


def touched_blocks(slot, n_tokens, max_nb: int, block_size: int
                   ) -> np.ndarray:
    """(b, max_nb) bool: logical blocks covered by a write of ``n_tokens``
    rows starting at ``slot`` (both (b,) int host arrays; n_tokens == 0 ->
    none)."""
    slot = np.asarray(slot, np.int64)
    n = np.asarray(n_tokens, np.int64)
    lo = slot // block_size
    hi = (slot + np.maximum(n, 1) - 1) // block_size
    ar = np.arange(max_nb)[None]
    return (ar >= lo[:, None]) & (ar <= hi[:, None]) & (n > 0)[:, None]
