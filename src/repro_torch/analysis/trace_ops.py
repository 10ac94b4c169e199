"""Scope queries over a ``torch.profiler`` trace (the port's form of the
scope queries of ``repro/analysis/hlo.py``: ``gathers_in_scope``).

The reference reads ``jax.named_scope`` labels out of the compiled HLO's
op metadata.  Eager PyTorch has no module to read; its counterpart of a
named scope is a ``record_function`` range (``core/plan.py``'s
``plan_scores`` / ``plan_materialize``, ``kernels/ops.py``'s ``ops_*``,
the registry's spans), and the ops it ran are the aten ops the profiler
records under that range.  These queries need CPU activity only: they
read the ranges' CPU-side events and their children, never the CUDA
kernel records, which ``torch.profiler`` drops in some sessions.

``collective_bytes`` and ``while_trip_counts`` have no counterpart yet:
they wait for distributed serving.
"""
from __future__ import annotations

import re
from typing import List, Set

# aten ops that read rows at computed indices: the per-token or per-block
# gathers a materialized plan costs (``index_put_`` writes, not reads)
GATHER_RE = re.compile(r"^aten::(gather|index|index_select|take|"
                       r"take_along_dim|embedding)$")


def _cpu_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CPU]


def range_names(prof) -> Set[str]:
    """Names of every CPU-side event in the trace (ops and ranges)."""
    return {e.name for e in _cpu_events(prof)}


def ops_in_scope(prof, scope: str) -> List[str]:
    """Names of every event recorded under each ``record_function(scope)``
    range of the trace (its descendants, depth first, in trace order)."""
    out: List[str] = []
    for e in _cpu_events(prof):
        if e.name != scope:
            continue
        stack = list(reversed(e.cpu_children))
        while stack:
            c = stack.pop()
            out.append(c.name)
            stack.extend(reversed(c.cpu_children))
    return out


def gathers_in_scope(prof, scope: str) -> List[str]:
    """The gather / index ops recorded under ``scope`` (``GATHER_RE``).

    The fused-route check uses this as the reference uses its HLO query:
    the staged route's ``plan_materialize`` holds gathers, the fused
    route's holds none.  Callers should first assert that the scope is
    present on the staged route, so a range that stopped being recorded
    fails loudly instead of passing vacuously."""
    return [n for n in ops_in_scope(prof, scope) if GATHER_RE.match(n)]
