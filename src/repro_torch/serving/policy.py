"""Scheduling policy layer: WHAT to run next, separated from the HOW
(counterpart of ``repro/serving/policy.py``, pure Python).

The scheduler (serving/scheduler.py) owns the mechanics — block
reservation, prefix matching, lifecycle transitions, suspend/resume — and
delegates every ordering/preemption CHOICE to a ``SchedPolicy``:

  * ``order_admission``  which waiting/suspended requests to try to admit,
    in which order, and whether a blocked candidate blocks everyone behind
    it (``strict`` — head-of-line) or is skipped.
  * ``order_prefill``    which admitted requests' prompt chunks to pack
    into the next engine step while the token budget lasts.
  * ``pick_victim``      which running decode (if any) to SUSPEND so a
    blocked candidate can be admitted: the victim's blocks park on the
    pool's LRU list (the host tier is not ported), its slot frees, and it
    is resumed later through the prefix-cache machinery.

Two implementations:

``FCFSPolicy`` reproduces the pre-policy scheduler token- and
step-identically: arrival order, strict head-of-line blocking, never
preempts.  It is the default.

``SLOPolicy`` targets latency SLOs under multi-tenant load:

  * admission is earliest-deadline-first over the per-request TTFT
    deadline (``Request.ttft_deadline_s``, absolute deadline =
    ``arrival_s + ttft_deadline_s``), ties broken by priority (higher
    first) and then per-tenant weighted fairness (tenants that have
    consumed less service per unit weight go first); no head-of-line
    blocking — a blocked candidate is skipped, not waited on.
  * prefill packing follows the same urgency order, so a
    deadline-at-risk request's chunks pre-empt the token budget.
  * when a deadline-carrying candidate is blocked on pool/slot capacity
    and its deadline is within ``risk_frac`` of expiring, the policy
    names a victim among the running decodes — lowest priority first,
    then the tenant with the most service per weight, then the decode
    that has run longest — and the scheduler suspends it.  A victim is
    only chosen whose own deadline is STRICTLY later than the
    candidate's (ties preempting each other would never terminate).

Fairness accounting is virtual-time-style: the scheduler reports every
processed token via ``note_work`` and the policy accumulates
``service / weight`` per tenant; ordering prefers the smallest.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.serving import request as rq

_INF = float("inf")


class SchedPolicy:
    """Interface + FCFS-shaped defaults.  Stateless unless a subclass
    keeps fairness accounting; one policy instance belongs to one
    scheduler."""

    name = "base"
    #: a blocked admission candidate blocks everything behind it
    strict = True
    #: the scheduler must size block tables for suspend/resume worst cases
    may_preempt = False

    def order_admission(self, suspended: Sequence["rq.Request"],
                        waiting: Sequence["rq.Request"],
                        now: float) -> List["rq.Request"]:
        """Candidates for (re-)admission this step, most urgent first.
        Suspended requests come back through the same gate — their work is
        sunk, so the defaults resume them before admitting new work."""
        return list(suspended) + list(waiting)

    def order_prefill(self, prefilling: Sequence["rq.Request"],
                      now: float) -> List["rq.Request"]:
        """Order in which admitted requests' prompt chunks are packed."""
        return list(prefilling)

    def pick_victim(self, blocked: "rq.Request",
                    decoding: Sequence["rq.Request"],
                    now: float) -> Optional["rq.Request"]:
        """A running decode to suspend so ``blocked`` can admit, or None
        (give up — ``blocked`` waits)."""
        return None

    def note_work(self, r: "rq.Request", tokens: int) -> None:
        """The scheduler processed ``tokens`` prompt/decode tokens for
        ``r`` (fairness accounting hook)."""


class FCFSPolicy(SchedPolicy):
    """Arrival order, head-of-line blocking, no preemption — byte-for-byte
    the pre-policy scheduler's behavior (tests/test_scheduler.py's parity
    suite runs through this path)."""

    name = "fcfs"


class SLOPolicy(SchedPolicy):
    """EDF admission + per-tenant weighted fairness + decode preemption.

    ``weights`` maps tenant -> relative share (default 1.0 each).
    ``risk_frac``: a blocked candidate may trigger preemption once
    ``now >= arrival + risk_frac * ttft_deadline`` (0.0 = preempt as soon
    as a deadline-carrying request is blocked; 1.0 = only after the
    deadline has already passed).
    """

    name = "slo"
    strict = False
    may_preempt = True

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 risk_frac: float = 0.25, preempt: bool = True):
        self.weights = dict(weights or {})
        self.risk_frac = float(risk_frac)
        self.may_preempt = bool(preempt)
        self._service: Dict[str, float] = {}    # tenant -> service/weight

    # ---- fairness accounting --------------------------------------------
    def _weight(self, tenant: str) -> float:
        return max(1e-9, float(self.weights.get(tenant, 1.0)))

    def _vt(self, tenant: str) -> float:
        return self._service.get(tenant, 0.0)

    def note_work(self, r: "rq.Request", tokens: int) -> None:
        t = r.tenant
        self._service[t] = self._vt(t) + tokens / self._weight(t)

    # ---- ordering --------------------------------------------------------
    @staticmethod
    def deadline(r: "rq.Request") -> float:
        """Absolute TTFT deadline (inf when the request carries none)."""
        return (_INF if r.ttft_deadline_s is None
                else r.arrival_s + r.ttft_deadline_s)

    def _urgency(self, r: "rq.Request"):
        return (self.deadline(r), -r.priority, self._vt(r.tenant),
                r.arrival_s, r.rid)

    def order_admission(self, suspended, waiting, now):
        return sorted(list(suspended) + list(waiting), key=self._urgency)

    def order_prefill(self, prefilling, now):
        return sorted(prefilling, key=self._urgency)

    # ---- preemption ------------------------------------------------------
    def at_risk(self, r: "rq.Request", now: float) -> bool:
        return (r.ttft_deadline_s is not None
                and now >= r.arrival_s + self.risk_frac * r.ttft_deadline_s)

    def pick_victim(self, blocked, decoding, now):
        if not self.may_preempt or not decoding \
                or not self.at_risk(blocked, now):
            return None
        bd = self.deadline(blocked)
        # STRICTLY later deadline only: allowing equal deadlines would let
        # two requests suspend each other in alternation forever (the
        # well-founded ordering is what guarantees admit() terminates)
        cands = [v for v in decoding if self.deadline(v) > bd]
        if not cands:
            return None
        # sacrifice the least urgent work: lowest priority, then the
        # most-served tenant, then the decode that has run longest (most
        # sunk KV — but also the one most likely to keep holding blocks)
        return max(cands, key=lambda v: (-v.priority, self._vt(v.tenant),
                                         len(v.out), -v.arrival_s, v.rid))


_POLICIES = {"fcfs": FCFSPolicy, "slo": SLOPolicy}


def resolve_policy(policy) -> SchedPolicy:
    """None | name | instance -> a policy instance (fresh per scheduler:
    SLOPolicy carries per-run fairness state)."""
    if policy is None:
        return FCFSPolicy()
    if isinstance(policy, SchedPolicy):
        return policy
    if isinstance(policy, str):
        try:
            return _POLICIES[policy]()
        except KeyError:
            raise ValueError(
                f"unknown scheduling policy {policy!r}; "
                f"choose from {sorted(_POLICIES)}") from None
    raise TypeError(f"policy must be None, a name or a SchedPolicy, "
                    f"got {type(policy).__name__}")
