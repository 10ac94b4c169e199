"""Paged KV pool for continuous batching, with cross-request prefix caching
(counterpart of ``repro/serving/pool.py``).

The device-side store is literally ``model.init_cache(num_blocks,
block_size)``: one ``KVCache`` per layer whose BATCH axis is the
physical-block axis and whose capacity axis is the within-block slot axis,
so every leaf is ``(N, block_size, n_kv, d)`` (``pos`` ``(N, block_size)``)
— the layout the paged selected-attention kernel reads.  Every leaf keeps
the ``pos``-derived mask semantics of serving/cache.py (``pos == -1`` marks
an empty/invalid slot).

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

Not ported yet: the host-memory tier behind the device pool (``HostTier``,
demotion / promotion / staging) and mesh placement; asking for either
raises.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.cache import KVCache

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


def _layers(data) -> Iterator[KVCache]:
    """Every layer's cache of a pool (or gathered view), in model order."""
    for stack in data:
        yield from stack


class PagedKVCache:
    """Fixed-size-block KV pool + per-request block tables + free-list +
    content-addressed prefix cache (refcounts, LRU eviction, COW tails)."""

    def __init__(self, model, num_blocks: int, block_size: int, mesh=None,
                 host_tier_blocks: int = 0):
        if mesh is not None:
            raise NotImplementedError("paged pool on a mesh is not yet "
                                      "ported")
        if host_tier_blocks:
            raise NotImplementedError("the host-memory tier "
                                      "(host_tier_blocks > 0) is not yet "
                                      "ported")
        self.model = model
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.data = model.init_cache(self.num_blocks, self.block_size)
        self._free: List[int] = list(range(self.num_blocks))
        self._tables: Dict[int, List[int]] = {}
        # ---- prefix cache state ----
        self._ref: Dict[int, int] = {}              # block -> live refcount
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # evictable
        self._reg: Dict[int, Tuple] = {}            # block -> registration
        self._full: Dict[int, int] = {}             # chain hash -> block
        self._tail: Dict[int, int] = {}             # prefix hash -> block
        # ---- counters (Engine.stats / ServeResult.prefix) ----
        self.evictions = 0
        self.cow_copies = 0
        self.lookups = 0
        self.hit_requests = 0
        self.hit_tokens = 0
        self.prompt_tokens = 0

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

    def can_alloc(self, n: int, exclude: Sequence[int] = ()) -> bool:
        """Can ``n`` FRESH blocks be produced (free list + LRU eviction),
        without evicting any block in ``exclude``?"""
        lru = len(self._lru) - sum(1 for b in exclude if b in self._lru)
        return n <= len(self._free) + lru

    def alloc(self, rid: int, n: int) -> List[int]:
        return self.alloc_prefix(rid, n)

    def alloc_prefix(self, rid: int, n_total: int,
                     shared: Sequence[int] = (),
                     cow: Optional[Tuple[int, int]] = None) -> List[int]:
        """Build request ``rid``'s table: ``shared`` prefix blocks (physical
        ids, refcount-pinned read-only) in logical order followed by the
        remaining fresh blocks.  ``cow = (src, keep)`` initialises the first
        fresh block as a copy of block ``src`` with slots >= ``keep``
        invalidated (shared partial tail)."""
        if rid in self._tables:
            raise RuntimeError(f"request {rid} already holds blocks")
        shared = list(shared)
        n_fresh = n_total - len(shared)
        protect = shared + ([cow[0]] if cow else [])
        if not self.can_alloc(n_fresh, exclude=protect):
            raise RuntimeError(
                f"pool exhausted: need {n_fresh} fresh blocks, "
                f"{len(self._free)} free + {len(self._lru)} evictable")
        # pin the shared prefix FIRST so fresh allocation cannot evict it
        for b in shared:
            self._pin(b)
        fresh, stale = [], []
        for _ in range(n_fresh):
            b, was_cached = self._take_fresh(protect)
            if was_cached:
                stale.append(b)
            fresh.append(b)
            self._ref[b] = 1
        self._stamp(stale)                 # evicted content is stale
        if cow is not None:
            src, keep = cow
            if src not in self._ref and src not in self._lru:
                raise RuntimeError(f"COW source block {src} not resident")
            _cow_block(self.data, src, fresh[0], keep)
            self.cow_copies += 1
        self._tables[rid] = shared + fresh
        return self._tables[rid]

    def free(self, rid: int) -> List[int]:
        """Release a request's blocks.  Registered blocks stay resident on
        the LRU list (matchable until evicted); the rest are pos=-1-stamped
        so no stale KV can leak into a later allocation.  Returns the
        blocks that landed on the LRU list."""
        blocks = self._tables.pop(rid)   # KeyError on double free
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
                    max_blocks: int) -> np.ndarray:
        """(rows, max_blocks) int32 block table, -1 padded (empty block).
        Rows beyond len(rids) are idle (all -1)."""
        tab = np.full((rows, max_blocks), -1, np.int32)
        for i, rid in enumerate(rids):
            blocks = self._tables[rid]
            tab[i, :len(blocks)] = blocks
        return tab

    # ---- prefix cache ----------------------------------------------------
    def match_prefix(self, tokens: np.ndarray,
                     chain: Optional[List[int]] = None
                     ) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest cached prefix of ``tokens``: (matched full blocks, tail).
        ``tail = (block, n_common)`` if a registered partial tail extends
        the matched full-block prefix by ``n_common`` shared tokens.
        ``chain`` is the precomputed ``_chain_hashes`` of ``tokens``."""
        toks = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        if chain is None:
            chain = _chain_hashes(toks, bs)
        h, fulls = _HASH_SEED, []
        for h2 in chain:
            b = self._full.get(h2)
            if b is None:
                break
            fulls.append(b)
            h = h2
        tail = None
        tb = self._tail.get(h)
        if tb is not None:
            t_toks = self._reg[tb][2]
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

    def suspend(self, rid: int, tokens: np.ndarray) -> None:
        """Preemption: release request ``rid``'s blocks with their KV kept
        matchable for resume (content-registered, then parked on the LRU
        list; pressure in between is real cache loss and forces a
        replay)."""
        self.register_suspend(rid, tokens)
        self.free(rid)

    def stage(self, slot: int) -> bool:
        raise NotImplementedError("host-tier staging is not yet ported")

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

    def _take_fresh(self, protect: Sequence[int]) -> Tuple[int, bool]:
        """One fresh block: free list first, then LRU eviction (the evicted
        block loses its cache entry).  Returns (block, needs stamping) —
        free-list blocks were stamped when freed."""
        if self._free:
            return self._free.pop(), False
        for b in self._lru:                        # oldest first
            if b not in protect:
                del self._lru[b]
                self._unregister(b)
                self.evictions += 1
                return b, True
        raise RuntimeError("pool exhausted: no evictable block")

    def _unregister(self, b: int) -> None:
        reg = self._reg.pop(b)
        index = self._full if reg[0] == "full" else self._tail
        if index.get(reg[1]) == b:
            del index[reg[1]]

    def _stamp(self, blocks: List[int]) -> None:
        """pos=-1-stamp ``blocks`` on device: recycled blocks must read as
        empty (a donor's stale positions would pass the validity masks)."""
        if blocks:
            _stamp_blocks(self.data, torch.as_tensor(blocks,
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


# ---------------------------------------------------------------------------
# device helpers (in place on the pool tensors)
# ---------------------------------------------------------------------------

def _stamp_blocks(data, ids: torch.Tensor) -> None:
    """Set pos = -1 across blocks ``ids``.  Only positions are stamped; KV
    payloads stay in place — the position masks make them unreadable."""
    for kv in _layers(data):
        kv.pos.index_fill_(0, ids, -1)


def _cow_block(data, src: int, dst: int, keep: int) -> None:
    """Copy block ``src`` into ``dst`` (copy-on-write of a shared partial
    tail), invalidating slots >= ``keep``: those hold the donor's private
    suffix/decode KV, which the sharer must not see."""
    for kv in _layers(data):
        kv.k[dst] = kv.k[src]
        kv.v[dst] = kv.v[src]
        kv.pos[dst] = kv.pos[src]
        kv.pos[dst, keep:] = -1


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
    Returns the pool's nested structure of ``KVCache`` views with leaves
    (b, max_nb * block_size, ...) — a standard linear cache — where empty
    blocks read as pos = -1 and zero K/V, so the position-mask machinery
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
        return [[KVCache(k=g(kv.k, 0), v=g(kv.v, 0), pos=g(kv.pos, -1))
                 for kv in stack] for stack in data]


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
        for kv, gv in zip(_layers(data), _layers(gathered)):
            for pool_leaf, gath_leaf in ((kv.k, gv.k), (kv.v, gv.v),
                                         (kv.pos, gv.pos)):
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
