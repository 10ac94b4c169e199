"""Request lifecycle for the continuous-batching scheduler (counterpart
of ``repro/serving/request.py``, pure Python).

A request moves WAITING -> PREFILL -> DECODE -> DONE, with a SUSPENDED
detour when the policy preempts it:

  WAITING    queued; not yet admitted (pool capacity / batch-slot gated)
  PREFILL    admitted; its prompt is being consumed chunk-by-chunk (B_CP at
             a time, interleaved with other requests' chunks and decodes)
  DECODE     prompt fully prefilled; one token per engine decode step
  SUSPENDED  preempted mid-decode: its KV blocks were registered in the
             prefix cache and released (parked on the pool's LRU list),
             its batch slot freed.  Re-admission matches the preserved
             KV (``resume_len`` covers any evicted suffix that must be
             replayed) and decoding continues where it stopped.
  DONE       finished on EOS / stop / length; its pool blocks are freed

SLO metadata (``tenant`` / ``priority`` / ``ttft_deadline_s``) is consumed
by serving/policy.py; the FCFS default ignores it.  All fields are
host-side bookkeeping (numpy / python) — device state lives in the paged
pool (serving/pool.py), addressed by the request's block table.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

import numpy as np

WAITING = "waiting"
PREFILL = "prefill"
DECODE = "decode"
SUSPENDED = "suspended"
DONE = "done"


@dataclass
class Request:
    rid: int
    tokens: np.ndarray              # (T,) int32 prompt
    max_new: int
    eos_id: Optional[int] = None    # stop token (None = length-only)
    arrival_s: float = 0.0          # arrival offset into the trace
    # ---- SLO metadata (serving/policy.py) ----
    tenant: str = "default"
    priority: int = 0               # higher = more important (ties only)
    ttft_deadline_s: Optional[float] = None   # TTFT SLO, relative to arrival
    # ---- runtime state (scheduler-owned) ----
    status: str = WAITING
    n_prefilled: int = 0            # prompt tokens consumed so far
    cached_len: int = 0             # prompt tokens served from the prefix
                                    # cache at admission (never recomputed)
    out: List[int] = field(default_factory=list)   # generated tokens
    ttft_s: Optional[float] = None
    done_s: Optional[float] = None
    preemptions: int = 0            # times suspended (policy decision)
    resume_len: int = 0             # >0 while resuming: prefill must reach
                                    # this many tokens of prompt+generated
                                    # KV before decoding continues

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def decode_pos(self) -> int:
        """Cache slot / absolute position of the NEXT decode write: the
        last emitted token (not yet in the cache) goes at this position."""
        return self.prompt_len + len(self.out) - 1

    @property
    def kv_len(self) -> int:
        """Tokens whose KV the cache holds once prefill is complete and
        ``len(out)`` tokens are emitted: the prompt plus every generated
        token except the last (its KV is written by the NEXT decode step).
        This is what suspend must preserve and resume must restore."""
        return self.prompt_len + max(0, len(self.out) - 1)

    def seq_tokens(self) -> np.ndarray:
        """Prompt followed by the generated tokens (the full sequence the
        cache's KV corresponds to, one position per token)."""
        if not self.out:
            return self.tokens
        return np.concatenate(
            [self.tokens, np.asarray(self.out, np.int32)])

    @property
    def prefill_target(self) -> int:
        """Prefill finishes when ``n_prefilled`` reaches this: the prompt
        normally, the preserved-KV length when resuming from suspension."""
        return self.resume_len if self.resume_len else self.prompt_len

    def next_chunk(self, chunk_size: int):
        """(tokens (chunk_size,), start, valid_len) for the next prompt —
        or, when resuming, prompt+generated — chunk; the tail chunk is
        right-padded with zeros (pos = -1)."""
        src = self.seq_tokens() if self.resume_len else self.tokens
        start = self.n_prefilled
        vlen = min(chunk_size, self.prefill_target - start)
        buf = np.zeros((chunk_size,), np.int32)
        buf[:vlen] = src[start:start + vlen]
        return buf, start, vlen

    def finished(self) -> bool:
        if len(self.out) >= self.max_new:
            return True
        return (self.eos_id is not None and len(self.out) > 0
                and self.out[-1] == self.eos_id)


def _per_request(val, n: int, name: str) -> list:
    """Broadcast a scalar (or None) to n, or validate a length-n sequence."""
    if val is None or np.isscalar(val) or isinstance(val, (int, float, str)):
        return [val] * n
    val = list(val)
    if len(val) != n:
        raise ValueError(f"{name} has {len(val)} entries for {n} prompts")
    return val


def make_requests(prompts, max_new: Union[int, Sequence[int]], *,
                  eos_id=None, arrivals=None, tenants=None,
                  priorities=None, ttft_deadlines=None) -> List[Request]:
    """Convenience: one Request per 1-D prompt array.

    ``max_new`` / ``eos_id`` / ``tenants`` / ``priorities`` /
    ``ttft_deadlines`` may each be a scalar (shared by every request) or a
    per-request sequence — heterogeneous traces are what the multi-tenant
    SLO scenarios are made of."""
    n = len(prompts)
    arrivals = arrivals if arrivals is not None else [0.0] * n
    if len(arrivals) != n:
        raise ValueError(f"{len(arrivals)} arrivals for {n} prompts")
    max_news = _per_request(max_new, n, "max_new")
    eos_ids = _per_request(eos_id, n, "eos_id")
    tens = _per_request(tenants if tenants is not None else "default",
                        n, "tenants")
    prios = _per_request(priorities if priorities is not None else 0,
                         n, "priorities")
    dls = _per_request(ttft_deadlines, n, "ttft_deadlines")
    return [Request(rid=i, tokens=np.asarray(p, np.int32).reshape(-1),
                    max_new=int(m), eos_id=(None if e is None else int(e)),
                    arrival_s=float(a), tenant=str(t), priority=int(pr),
                    ttft_deadline_s=(None if d is None else float(d)))
            for i, (p, a, m, e, t, pr, d)
            in enumerate(zip(prompts, arrivals, max_news, eos_ids,
                             tens, prios, dls))]
