"""Continuous-batching scheduler: MECHANICS only — ordering and preemption
choices live in a pluggable ``SchedPolicy`` (serving/policy.py).
Counterpart of ``repro/serving/scheduler.py``, host-side Python, with the
reference's ``sched/*``, ``tenant/*`` and ``serve/deadline_*`` counters and
``sched/suspend`` / ``sched/resume`` spans in an ``obs.Registry``.

Per engine step:

  1. ``admit``: the policy orders the waiting + suspended requests; each
     candidate is admitted while (a) a batch slot is free (active requests
     < ``max_decode_batch``) and (b) the pool can reserve its blocks.
     Reservation is conservative — ceil((padded_prefill_span + max_new) /
     block_size) blocks up front — so a running request can never OOM
     mid-flight.  A blocked candidate either blocks everything behind it
     (``policy.strict``, FCFS head-of-line) or is skipped (SLO); the
     policy may instead name a running decode to SUSPEND (see below) and
     retry.  With prefix caching on, admission first matches the
     request's longest cached prefix (full blocks + COW tail, floored to
     ``prefix_align``), pins the shared blocks into its table and admits
     it with only the uncached suffix as prefill work (``n_prefilled``
     starts at the hit length).  With the host tier on, matched entries
     may be ``("host", slot)``: cached work, but not cached blocks — each
     is promoted into a fresh device block, so only device entries lower
     the fresh-block demand or are protected from eviction.
  2. ``pack_prefill``: pending prompt chunks in policy order, one B_CP
     chunk per request (chunks of one request are sequential), charging
     the chunk's REAL token count (rounded to ``token_grid``) against
     ``max_prefill_tokens`` and capping rows at the compiled
     ``max_prefill_rows`` geometry.
  3. ``pack_decode``: ALL active decode requests (bounded by admission).

Preemption (suspend/resume): suspending a DECODE request registers its
blocks — prompt AND generated KV — in the pool's content-addressed prefix
cache and frees them (demoted to the host tier when there is one, parked
on the LRU list otherwise), freeing its batch slot.
Resume is re-admission through the same prefix-match machinery: the
preserved KV comes back as a cache hit covering ``Request.kv_len`` tokens,
and any suffix lost to eviction in between is replayed in prefill chunks
(``resume_len``) before decoding continues.  With the KV intact, a
suspend -> resume round trip is token-identical to running uninterrupted;
a replay after cache loss is exact for ``full`` (chunking-invariant) and
a documented approximation for selection methods (the replayed chunks
re-select over the generated region).

Completion (EOS / stop / length) frees the request's blocks; registered
prefix blocks stay resident (LRU) until memory pressure.

``prefix_align`` guards exactness: a cache hit replays KV the donor
computed with chunk boundaries at multiples of B_CP starting from 0.
Selection-based methods (QUOKA & baselines) score per chunk, so their
outputs are only reproducible when the sharer's suffix chunks land on the
same grid — hits must be floored to a chunk multiple.  Dense attention is
chunking-invariant, so ``full`` can share at token granularity (COW tails).
The scheduler is pure host-side policy; device work happens in the engine.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.serving import request as rq
from repro_torch.serving.policy import SchedPolicy, resolve_policy
from repro_torch.serving.pool import (PagedKVCache, _chain_hashes,
                                      blocks_for_request, blocks_for_resume,
                                      max_blocks_bound)
from repro_torch.obs import registry as obs_reg


def _device_entries(shared: List, cow) -> Tuple[List[int], List[int]]:
    """(device-resident shared blocks, blocks to protect from eviction) of
    a hit: ``("host", slot)`` entries are promoted into fresh blocks, so
    only device ids share for free or can be protected."""
    dev_shared = [b for b in shared if not isinstance(b, tuple)]
    protect = dev_shared + \
        ([cow[0]] if cow and not isinstance(cow[0], tuple) else [])
    return dev_shared, protect


class Scheduler:
    def __init__(self, pool: PagedKVCache, chunk_size: int,
                 max_prefill_tokens: int, max_decode_batch: int,
                 prefix_cache: bool = False, prefix_align: int = 1,
                 registry=None, policy=None,
                 max_prefill_rows: Optional[int] = None,
                 token_grid: int = 1):
        assert max_prefill_tokens >= chunk_size, \
            "max_prefill_tokens must fit at least one chunk"
        # lifecycle counters under sched/ (obs/registry.py): the default
        # NULL registry makes every count() a no-op; the plain-int twins
        # below feed ServeResult either way
        self.reg = registry if registry is not None else obs_reg.NULL
        self.pool = pool
        self.policy: SchedPolicy = resolve_policy(policy)
        self.chunk_size = int(chunk_size)
        self.max_prefill_tokens = int(max_prefill_tokens)
        # compiled prefill-row geometry: how many chunk rows one step can
        # carry.  Defaults to the full-chunk capacity of the token budget;
        # a larger value lets short tail chunks — charged their REAL
        # length — pack together instead of each eating a whole padded
        # chunk of budget (the pack_prefill tail-charging fix)
        self.max_prefill_rows = int(
            max_prefill_rows if max_prefill_rows is not None
            else max(1, self.max_prefill_tokens // self.chunk_size))
        self.token_grid = max(1, int(token_grid))
        self.max_decode_batch = int(max_decode_batch)
        self.prefix_cache = bool(prefix_cache)
        self.prefix_align = max(1, int(prefix_align))
        self.waiting: List[rq.Request] = []
        self.prefilling: List[rq.Request] = []
        self.decoding: List[rq.Request] = []
        self.suspended: List[rq.Request] = []
        self.done: List[rq.Request] = []
        # plain-int counters (ServeResult fields; the registry mirrors them)
        self.preemptions = 0
        self.resumes = 0
        self.resume_replays = 0
        self.deadline_misses = 0
        # rid -> precomputed _chain_hashes of the prompt: admit() re-matches
        # a pool-blocked head request EVERY engine step, and O(prompt_len)
        # re-hashing per step would tax every interleaved decode step
        self._chain: Dict[int, List[int]] = {}
        # rid -> chain hashes of the SUSPENDED kv sequence (prompt +
        # generated); invalidated on suspend — kv grows between rounds
        self._rchain: Dict[int, List[int]] = {}

    # ------------------------------------------------------------------
    def blocks_needed(self, r: rq.Request, cached_len: int = 0) -> int:
        return blocks_for_request(r.prompt_len, r.max_new, self.chunk_size,
                                  self.pool.block_size, cached_len=cached_len)

    def add(self, r: rq.Request) -> None:
        n = self.blocks_needed(r)
        if self.policy.may_preempt:
            # a preemptible request must also fit its worst-case RESUME
            # reservation, or a suspended request could deadlock waiting
            # on a pool it can never re-enter
            n = max(n, max_blocks_bound(
                r.prompt_len, r.max_new, self.chunk_size,
                self.pool.block_size, align=self.prefix_align,
                preempt=True))
        if n > self.pool.num_blocks:
            raise ValueError(
                f"request {r.rid} needs {n} blocks > pool size "
                f"{self.pool.num_blocks}; it can never be admitted")
        # reset ALL runtime state so a Request object can be re-served
        # (warmup-then-measure traces); stale n_prefilled/out would make a
        # re-served request complete instantly with the previous run's tokens
        r.status = rq.WAITING
        r.n_prefilled = 0
        r.cached_len = 0
        r.out = []
        r.ttft_s = None
        r.done_s = None
        r.preemptions = 0
        r.resume_len = 0
        self._chain.pop(r.rid, None)       # rid may carry new tokens
        self._rchain.pop(r.rid, None)
        self.waiting.append(r)
        self.reg.count("sched/submitted")

    def pending(self) -> bool:
        return bool(self.waiting or self.prefilling or self.decoding
                    or self.suspended)

    @property
    def n_active(self) -> int:
        return len(self.prefilling) + len(self.decoding)

    # ------------------------------------------------------------------
    def _match(self, r: rq.Request) -> Tuple[int, List,
                                             Optional[Tuple]]:
        """Longest usable cached prefix of ``r``: (cached_len, shared full
        blocks, cow) with cached_len floored to ``prefix_align`` and capped
        at prompt_len - 1 (at least one token must be recomputed to produce
        the first-token logits)."""
        chain = self._chain.get(r.rid)
        if chain is None:
            chain = self._chain[r.rid] = _chain_hashes(
                r.tokens, self.pool.block_size)
        fulls, tail = self.pool.match_prefix(r.tokens, chain=chain)
        bs = self.pool.block_size
        matched = len(fulls) * bs + (tail[1] if tail else 0)
        cached = (min(matched, r.prompt_len - 1)
                  // self.prefix_align) * self.prefix_align
        return self._hit(cached, fulls, tail)

    def _hit(self, cached: int, fulls: List, tail) -> Tuple[int, List,
                                                            Optional[Tuple]]:
        """(cached, shared full blocks, cow) for a hit of ``cached`` tokens
        out of a ``match_prefix`` result."""
        if cached <= 0:
            return 0, [], None
        bs = self.pool.block_size
        n_shared, keep = divmod(cached, bs)
        shared = fulls[:n_shared]
        cow = None
        if keep:
            src = fulls[n_shared] if n_shared < len(fulls) else tail[0]
            cow = (src, keep)
        return cached, shared, cow

    def admit(self, now: float = 0.0) -> List[rq.Request]:
        """(Re-)admit requests in policy order.  A blocked candidate may
        trigger a preemption (``policy.pick_victim`` names a running
        decode to suspend) and is retried; under a strict policy it
        blocks everything behind it instead."""
        admitted = []
        # preemption cap per admit() call: the policy's strict-deadline
        # victim ordering already rules out suspend cycles, but a buggy
        # policy must degrade to "stops preempting", not an infinite loop
        preempts_left = len(self.decoding) + len(self.suspended) + 1
        while self.waiting or self.suspended:
            progressed = False
            order = self.policy.order_admission(self.suspended,
                                                self.waiting, now)
            if self.n_active >= self.max_decode_batch:
                # batch slots exhausted: only a preemption can make room
                for r in order:
                    victim = (self.policy.pick_victim(r, self.decoding, now)
                              if preempts_left > 0 else None)
                    if victim is not None:
                        self.suspend(victim, now)
                        preempts_left -= 1
                        progressed = True
                        break
                    if self.policy.strict:
                        break
                if not progressed:
                    break
                continue
            for r in order:
                if self._try_admit(r, now):
                    admitted.append(r)
                    progressed = True
                    break
                victim = (self.policy.pick_victim(r, self.decoding, now)
                          if preempts_left > 0 else None)
                if victim is not None:
                    self.suspend(victim, now)
                    preempts_left -= 1
                    progressed = True      # retry r against the freed pool
                    break
                if self.policy.strict:
                    break                  # FCFS: no skipping the head
            if not progressed:
                break
        return admitted

    def _try_admit(self, r: rq.Request, now: float) -> bool:
        if r.status == rq.SUSPENDED:
            return self._try_resume(r, now)
        pool = self.pool
        cached, shared, cow = (self._match(r) if self.prefix_cache
                               else (0, [], None))
        n = self.blocks_needed(r, cached_len=cached)
        dev_shared, protect = _device_entries(shared, cow)
        if cached and not pool.can_alloc(n - len(dev_shared),
                                         exclude=protect):
            # a hit can demand MORE of the pool than a cold admit: a
            # token-granularity hit shifts the chunk grid (up to one
            # extra block of padding) and its shared/COW-source blocks
            # are protected from eviction.  Degrade to a cold admit
            # rather than stalling the candidate on a pool the request
            # fits cold.
            cached, shared, cow, dev_shared, protect = 0, [], None, [], []
            n = self.blocks_needed(r)
            self.reg.count("sched/hit_degraded")
        if not pool.can_alloc(n - len(dev_shared), exclude=protect):
            return False
        n_promote = len(shared) - len(dev_shared)
        if n_promote:
            self.reg.count("sched/promoted_blocks", float(n_promote))
        pool.alloc_prefix(r.rid, n, shared, cow)
        pool.lookups += 1
        pool.prompt_tokens += r.prompt_len
        if cached:
            pool.hit_requests += 1
            pool.hit_tokens += cached
        r.cached_len = cached
        r.n_prefilled = cached         # prefill only the uncached suffix
        r.status = rq.PREFILL
        self.waiting.remove(r)
        self.prefilling.append(r)
        self.reg.count("sched/admitted")
        if cached:
            self.reg.count("sched/prefix_hit_requests")
            self.reg.count("sched/prefix_hit_tokens", float(cached))
        return True

    # ---- suspend / resume ------------------------------------------------
    def suspend(self, r: rq.Request, now: float) -> None:
        """Preempt a DECODE request: its KV blocks are content-registered
        and released (demoted to the host tier when there is one), its
        batch slot freed.  The request parks in ``suspended`` until the policy
        re-admits it."""
        assert r.status == rq.DECODE, \
            f"only decoding requests are preemptible (rid {r.rid} is " \
            f"{r.status})"
        seq_kv = r.seq_tokens()[:r.kv_len]
        with self.reg.span("sched/suspend", rid=r.rid):
            _, demoted = self.pool.suspend(r.rid, seq_kv)
        self.decoding.remove(r)
        r.status = rq.SUSPENDED
        r.preemptions += 1
        self.suspended.append(r)
        self._rchain.pop(r.rid, None)     # kv grew since any prior suspend
        self.preemptions += 1
        self.reg.count("sched/preemptions")
        self.reg.count(f"tenant/{r.tenant}/preemptions")
        if demoted:
            self.reg.count("sched/suspend_demoted_blocks", float(demoted))

    def _try_resume(self, r: rq.Request, now: float) -> bool:
        """Re-admit a suspended request: match the preserved prompt +
        generated KV as a prefix hit; a suffix lost to eviction since the
        suspend is replayed in prefill chunks (``resume_len``) before
        decoding continues."""
        pool = self.pool
        kv = r.seq_tokens()[:r.kv_len]
        chain = self._rchain.get(r.rid)
        if chain is None:
            chain = self._rchain[r.rid] = _chain_hashes(kv, pool.block_size)
        fulls, tail = pool.match_prefix(kv, chain=chain)
        matched = len(fulls) * pool.block_size + (tail[1] if tail else 0)
        cached = min(matched, r.kv_len)
        if cached < r.kv_len:
            # replay chunks must land on the align grid (selection methods
            # are chunk-grid-sensitive; ``full`` shares at any offset)
            cached = (cached // self.prefix_align) * self.prefix_align
        cached, shared, cow = self._hit(cached, fulls, tail)
        n = blocks_for_resume(r.kv_len, r.prompt_len, r.max_new,
                              self.chunk_size, pool.block_size, cached)
        dev_shared, protect = _device_entries(shared, cow)
        if cached and not pool.can_alloc(n - len(dev_shared),
                                         exclude=protect):
            # same degrade as fresh admission: a hit's protected blocks can
            # exceed what a hit-free reservation needs; fall back to a full
            # replay-from-scratch resume rather than stalling (the preempt
            # admission bound guarantees the cold reservation fits)
            cached, shared, cow, dev_shared, protect = 0, [], None, [], []
            n = blocks_for_resume(r.kv_len, r.prompt_len, r.max_new,
                                  self.chunk_size, pool.block_size, 0)
            self.reg.count("sched/hit_degraded")
        if not pool.can_alloc(n - len(dev_shared), exclude=protect):
            return False
        with self.reg.span("sched/resume", rid=r.rid):
            pool.alloc_prefix(r.rid, n, shared, cow)
        self._rchain.pop(r.rid, None)
        self.suspended.remove(r)
        self.resumes += 1
        self.reg.count("sched/resumes")
        if cached >= r.kv_len:
            r.resume_len = 0
            r.n_prefilled = r.prompt_len
            r.status = rq.DECODE
            self.decoding.append(r)
        else:
            r.resume_len = r.kv_len
            r.n_prefilled = cached
            r.status = rq.PREFILL
            self.prefilling.append(r)
            self.resume_replays += 1
            self.reg.count("sched/resume_replay_tokens",
                           float(r.kv_len - cached))
        return True

    # ------------------------------------------------------------------
    def pack_prefill(self, now: float = 0.0
                     ) -> List[Tuple[rq.Request, "object", int, int]]:
        """[(request, chunk_tokens, start, valid_len)] — one chunk per
        request, in policy order, until the token budget or the compiled
        row geometry is spent.  A chunk charges its REAL valid length
        (rounded up to ``token_grid``, capped at the chunk width) against
        ``max_prefill_tokens`` — a short tail no longer eats a whole
        padded chunk of budget, so tails pack together when
        ``max_prefill_rows`` leaves room."""
        rows = []
        budget = self.max_prefill_tokens
        g = self.token_grid
        for r in self.policy.order_prefill(list(self.prefilling), now):
            if len(rows) >= self.max_prefill_rows:
                break
            vnext = min(self.chunk_size, r.prefill_target - r.n_prefilled)
            charge = min(self.chunk_size, -(-vnext // g) * g)
            if charge > budget:
                break
            tok, start, vlen = r.next_chunk(self.chunk_size)
            rows.append((r, tok, start, vlen))
            budget -= charge
        return rows

    def note_prefilled(self, r: rq.Request, vlen: int,
                       first_token: Optional[int],
                       now: float) -> Optional[int]:
        """Returns the emitted first token (prompt prefill just completed)
        or None (mid-prompt, or a resume replay — whose final chunk
        re-predicts the already-emitted ``out[-1]`` and is discarded)."""
        r.n_prefilled += vlen
        self.policy.note_work(r, vlen)
        if r.n_prefilled < r.prefill_target:
            return None
        if r.resume_len:
            # resume replay complete: decoding continues from out[-1]
            r.resume_len = 0
            r.status = rq.DECODE
            self.prefilling.remove(r)
            self.decoding.append(r)
            return None
        if self.prefix_cache:
            self.pool.register_prefix(r.rid, r.tokens,
                                      chain=self._chain.pop(r.rid, None))
        r.status = rq.DECODE
        r.out.append(int(first_token))
        r.ttft_s = now - r.arrival_s
        if r.ttft_deadline_s is not None:
            if r.ttft_s > r.ttft_deadline_s:
                self.deadline_misses += 1
                self.reg.count("serve/deadline_miss")
                self.reg.count(f"tenant/{r.tenant}/deadline_miss")
            else:
                self.reg.count(f"tenant/{r.tenant}/deadline_met")
        self.prefilling.remove(r)
        if r.finished():               # max_new == 1 or instant EOS
            self._finish(r, now)
        else:
            self.decoding.append(r)
        return r.out[-1]

    def pack_decode(self) -> List[rq.Request]:
        return list(self.decoding)

    def note_decoded(self, r: rq.Request, token: int, now: float) -> int:
        r.out.append(int(token))
        self.policy.note_work(r, 1)
        if r.finished():
            self.decoding.remove(r)
            self._finish(r, now)
        return r.out[-1]

    def _finish(self, r: rq.Request, now: float) -> None:
        r.status = rq.DONE
        r.done_s = now
        self.pool.free(r.rid)      # registered prefix blocks stay resident
        self.done.append(r)
        self.reg.count("sched/finished")
        self.reg.count(f"tenant/{r.tenant}/finished")
