"""Serve-path metrics registry (counterpart of ``repro/obs/registry.py``):
counters, gauges, streaming histograms, named scopes and step spans, with
a no-op fast path when disabled.

  * **Low overhead.**  Instruments are plain ``__slots__`` objects; an
    update is one attribute store or float add.  A DISABLED registry hands
    out shared null instruments whose methods do nothing, and its ``span``
    is a reusable null context manager.  The serving engine also guards
    whole instrumentation blocks on one cached ``registry.enabled`` bool,
    so the metrics-off serve path does no per-step telemetry work.
  * **Streaming quantiles.**  Histograms keep exact count / sum / min /
    max plus a bounded algorithm-R reservoir seeded per instrument as the
    reference seeds it (``abs(hash(name)) % 2**31``, numpy's
    ``default_rng``), so the same stream gives the same quantiles in both
    packages within one process.
  * **Spans double as trace events.**  ``span(name)`` times a host region
    with ``time.perf_counter`` into the histogram of the same name and
    appends a Chrome/Perfetto ``ph: "X"`` event (``obs/export.py``).
    Where the reference enters ``jax.profiler.TraceAnnotation``, a span
    enters ``torch.profiler.record_function(name)`` and, once the process
    has a CUDA context, an NVTX range: both show on a ``torch.profiler``
    (or nsys) timeline, neither needs the profiler's kernel records.

The registry is serve-loop-local and not thread-safe.  Everything here is
host bookkeeping; the per-layer selection stats are device scalars from
``core/plan.py`` that the engine feeds in.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch


class Counter:
    """Monotonic float counter."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-value gauge."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming distribution: exact count/sum/min/max + an algorithm-R
    reservoir for quantiles, seeded per instrument (reproducible)."""
    __slots__ = ("count", "sum", "min", "max", "_res", "_cap", "_rng")

    def __init__(self, reservoir: int = 1024, seed: int = 0):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._cap = int(reservoir)
        self._res: List[float] = []
        self._rng = np.random.default_rng(seed)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._res) < self._cap:
            self._res.append(v)
        else:
            # algorithm R: item i replaces a reservoir slot w.p. cap/i
            j = int(self._rng.integers(0, self.count))
            if j < self._cap:
                self._res[j] = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def quantile(self, q: float) -> float:
        if not self._res:
            return float("nan")
        return float(np.quantile(np.asarray(self._res), q))

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.sum, "min": self.min,
                "max": self.max, "mean": self.mean,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}


# ---------------------------------------------------------------------------
# no-op twins (shared singletons handed out by a disabled registry)
# ---------------------------------------------------------------------------

class _NullCounter(Counter):
    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass


class _NullGauge(Gauge):
    __slots__ = ()

    def set(self, v: float) -> None:
        pass


class _NullHistogram(Histogram):
    __slots__ = ()

    def observe(self, v: float) -> None:
        pass


class _NullSpan:
    """Reusable null context manager (allocation-free enter/exit)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()
_NULL_SPAN = _NullSpan()


class _Span:
    """One timed host region: histogram sample + Chrome trace event + a
    ``record_function`` range (+ an NVTX range once CUDA is initialised)."""
    __slots__ = ("_reg", "_name", "_args", "_t0", "_rf", "_nvtx")

    def __init__(self, reg: "Registry", name: str, args: Optional[Dict]):
        self._reg = reg
        self._name = name
        self._args = args

    def __enter__(self):
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self._name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        reg = self._reg
        reg.histogram(self._name).observe(dt)
        ev = {"name": self._name, "ph": "X", "pid": 1, "tid": 1,
              "ts": (self._t0 - reg.t0) * 1e6, "dur": dt * 1e6}
        if self._args:
            ev["args"] = self._args
        reg.trace_events.append(ev)
        return False


class Registry:
    """Named-scope metrics registry.

    ``counter/gauge/histogram(name)`` create on demand; ``scope(prefix)``
    returns a view that prefixes every name with ``prefix/``.  ``span``
    times a region (histogram + trace event); ``event`` appends a raw
    JSONL record.  ``Registry(enabled=False)`` is the no-op fast path:
    every instrument is a shared null object and nothing is recorded.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.t0 = time.perf_counter()
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.events: List[Dict] = []          # JSONL event log
        self.trace_events: List[Dict] = []    # Chrome/Perfetto trace events

    # ---- instruments -----------------------------------------------------
    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL_COUNTER
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        if not self.enabled:
            return _NULL_HISTOGRAM
        h = self.histograms.get(name)
        if h is None:
            # per-instrument seed: stable within a process, decorrelated
            # across instruments
            h = self.histograms[name] = Histogram(
                seed=abs(hash(name)) % (2 ** 31))
        return h

    # ---- convenience -----------------------------------------------------
    def count(self, name: str, n: float = 1.0) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    def span(self, name: str, **args):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def event(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        self.events.append({"t_s": time.perf_counter() - self.t0,
                            "event": kind, **fields})

    def scope(self, prefix: str) -> "Scope":
        return Scope(self, prefix)

    # ---- views -----------------------------------------------------------
    def snapshot(self) -> Dict:
        """One plain-dict view of everything (exporters build on this)."""
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self.histograms.items())},
        }

    def view(self, prefix: str) -> Dict[str, float]:
        """Flat counters + gauges under ``prefix/``, keyed by the suffix:
        the shape of ``Engine.stats`` / ``ServeResult.prefix``."""
        pre = prefix.rstrip("/") + "/"
        out: Dict[str, float] = {}
        for k, c in self.counters.items():
            if k.startswith(pre):
                out[k[len(pre):]] = c.value
        for k, g in self.gauges.items():
            if k.startswith(pre):
                out[k[len(pre):]] = g.value
        return out


class Scope:
    """Name-prefixing view of a registry (``scope.counter("x")`` is
    ``reg.counter("prefix/x")``)."""
    __slots__ = ("_reg", "_prefix")

    def __init__(self, reg: Registry, prefix: str):
        self._reg = reg
        self._prefix = prefix.rstrip("/")

    @property
    def enabled(self) -> bool:
        return self._reg.enabled

    def _n(self, name: str) -> str:
        return f"{self._prefix}/{name}"

    def counter(self, name: str) -> Counter:
        return self._reg.counter(self._n(name))

    def gauge(self, name: str) -> Gauge:
        return self._reg.gauge(self._n(name))

    def histogram(self, name: str) -> Histogram:
        return self._reg.histogram(self._n(name))

    def count(self, name: str, n: float = 1.0) -> None:
        self._reg.count(self._n(name), n)

    def set(self, name: str, v: float) -> None:
        self._reg.set(self._n(name), v)

    def observe(self, name: str, v: float) -> None:
        self._reg.observe(self._n(name), v)

    def span(self, name: str, **args):
        return self._reg.span(self._n(name), **args)

    def event(self, kind: str, **fields) -> None:
        self._reg.event(kind, scope=self._prefix, **fields)

    def scope(self, prefix: str) -> "Scope":
        return Scope(self._reg, self._n(prefix))

    def view(self) -> Dict[str, float]:
        return self._reg.view(self._prefix)


#: the shared disabled registry — the default "metrics off" sink
NULL = Registry(enabled=False)
