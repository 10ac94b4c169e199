"""Registry exporters (counterpart of ``repro/obs/export.py``): a JSONL
event log, the Prometheus text format (0.0.4) and a Chrome-trace-format
span dump (openable at https://ui.perfetto.dev or chrome://tracing).

Each renders a ``Registry`` to plain text, byte for byte as the
reference's exporters render the same registry contents; none imports
the serving stack.
"""
from __future__ import annotations

import json
import math
import os
import re
from typing import Dict

from repro_torch.obs.registry import Registry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """A registry name ("serve/pool/occupancy") as a valid Prometheus
    metric name ("serve_pool_occupancy")."""
    n = _NAME_RE.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return n


def _prom_value(v: float) -> str:
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


# ---------------------------------------------------------------------------
# JSONL
# ---------------------------------------------------------------------------

def jsonl_lines(reg: Registry) -> str:
    """The event log, then one final ``snapshot`` record, one JSON object
    per line."""
    lines = [json.dumps(ev) for ev in reg.events]
    lines.append(json.dumps({"event": "snapshot", **reg.snapshot()}))
    return "\n".join(lines) + "\n"


def write_jsonl(reg: Registry, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(jsonl_lines(reg))
    return path


# ---------------------------------------------------------------------------
# Prometheus text exposition format
# ---------------------------------------------------------------------------

def prometheus_text(reg: Registry) -> str:
    """Counters, gauges and histogram summaries in the Prometheus text
    exposition format (0.0.4).  Histograms are summaries:
    ``<name>{quantile="0.5|0.9|0.99"}``, ``<name>_sum``, ``<name>_count``.
    """
    out = []
    snap = reg.snapshot()
    for name, val in snap["counters"].items():
        pn = _prom_name(name)
        out.append(f"# TYPE {pn} counter")
        out.append(f"{pn} {_prom_value(val)}")
    for name, val in snap["gauges"].items():
        pn = _prom_name(name)
        out.append(f"# TYPE {pn} gauge")
        out.append(f"{pn} {_prom_value(val)}")
    for name, s in snap["histograms"].items():
        pn = _prom_name(name)
        out.append(f"# TYPE {pn} summary")
        for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            out.append(f'{pn}{{quantile="{q}"}} {_prom_value(s[key])}')
        out.append(f"{pn}_sum {_prom_value(s['sum'])}")
        out.append(f"{pn}_count {int(s['count'])}")
    return "\n".join(out) + "\n"


def write_prometheus(reg: Registry, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(prometheus_text(reg))
    return path


# ---------------------------------------------------------------------------
# Chrome trace format (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------

def chrome_trace(reg: Registry) -> Dict:
    """The spans in the Chrome trace event format: complete ("ph": "X")
    events with microsecond ``ts``/``dur`` from the registry's creation.
    The process keeps the reference's name, so both packages' traces
    read alike."""
    return {
        "traceEvents": [
            {"name": "process_name", "ph": "M", "pid": 1,
             "args": {"name": "repro.serve"}},
            *reg.trace_events,
        ],
        "displayTimeUnit": "ms",
    }


def write_chrome_trace(reg: Registry, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(chrome_trace(reg), f)
    return path


def export_all(reg: Registry, out_dir: str, prefix: str = "serve") -> Dict[str, str]:
    """Write all three formats under ``out_dir``; returns {kind: path}."""
    return {
        "jsonl": write_jsonl(reg, os.path.join(out_dir, f"{prefix}.metrics.jsonl")),
        "prometheus": write_prometheus(reg, os.path.join(out_dir, f"{prefix}.prom")),
        "trace": write_chrome_trace(reg, os.path.join(out_dir, f"{prefix}.trace.json")),
    }
