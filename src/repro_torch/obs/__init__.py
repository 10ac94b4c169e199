"""Serve-path observability: metrics registry + exporters (counterpart of
``repro/obs``).

    from repro_torch import obs
    reg = obs.Registry()                    # or obs.NULL when disabled
    reg.count("serve/steps")
    with reg.span("serve/step/prefill", tokens=256):
        ...
    obs.export_all(reg, "out/metrics")

See obs/registry.py for the instrument model and obs/export.py for the
JSONL / Prometheus / Chrome-trace formats.
"""
from repro_torch.obs.registry import (  # noqa: F401
    NULL,
    Counter,
    Gauge,
    Histogram,
    Registry,
    Scope,
)
from repro_torch.obs.export import (  # noqa: F401
    chrome_trace,
    export_all,
    jsonl_lines,
    prometheus_text,
    write_chrome_trace,
    write_jsonl,
    write_prometheus,
)
