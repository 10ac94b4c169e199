"""Budget resolution and the baseline scorer dispatch (counterpart of
``repro/core/selection.py``).

QUOKA's own scorer is ``core/quoka.py`` (reached through
``core/plan.py::plan_scores``); the baseline scorers (SampleAttention,
SparQ, Loki, LessIsMore, SnapKV, KeyDiff) come in a later slice and
``compute_scores`` raises for them.
"""
from __future__ import annotations

from repro_torch.configs.base import QuokaConfig

BASELINES = ("sample_attention", "sparq", "loki", "less_is_more", "snapkv",
             "keydiff")


def compute_scores(method: str, q, k, valid, cfg: QuokaConfig):
    if method in BASELINES:
        raise NotImplementedError(f"selection method {method!r} is not yet "
                                  "ported")
    raise ValueError(f"unknown selection method {method!r}")


def floor_to_grid(budget: int, g: int) -> int:
    """Floor a token budget onto the g-token selection grid (min one
    block); granularity 1 is the identity."""
    if g <= 1:
        return budget
    return max(g, budget - budget % g)


def resolve_budget(cfg: QuokaConfig, context_len: int) -> int:
    """Effective B_SA: fixed, or a fraction of the static context length,
    floored onto the selection grid."""
    if cfg.budget_ratio is not None:
        budget = max(cfg.keep_first + 1, int(cfg.budget_ratio * context_len))
    else:
        budget = cfg.budget
    return floor_to_grid(budget, max(1, cfg.granularity))
