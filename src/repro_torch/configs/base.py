"""Config dataclasses for the port (counterpart of ``repro/configs/base.py``).

This slice ports the dense GQA decoder family only: block kind ``"attn"``.
Field names and defaults match the reference so a test can build the same
configuration in both packages; dtypes are torch dtypes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class QuokaConfig:
    """Paper Algorithm 1/2 hyper-parameters."""
    chunk_size: int = 128          # B_CP
    budget: int = 1024             # B_SA
    # B_SA as a fraction of the (static) cache capacity (paper Table 2)
    budget_ratio: Optional[float] = None
    n_queries: int = 16            # N_Q
    scoring: str = "cosine"        # "cosine" | "dot"   (Table 9 ablation)
    query_agg: str = "max"         # "max" | "mean"     (Table 10 ablation)
    keep_first: int = 4            # sink tokens always kept
    method: str = "quoka"
    # selection granularity in tokens: 1 = per-token top-k, >1 = blocks of
    # g tokens shared across KV heads (core/plan.py)
    granularity: int = 1
    # cross-layer plan reuse; only 1 (score every layer) is ported
    reuse_interval: int = 1
    correction_layers: Tuple[int, ...] = ()
    # low-rank scoring; only 0 (full head dim) is ported
    score_proj_dim: int = 0
    # route block-granular selection onto the fused selected-attention
    # kernel instead of materialize + attention (core/plan.py::fused_route)
    fused_select_attn: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    use_rope: bool = True
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"
    dtype: torch.dtype = torch.bfloat16
    source: str = ""
    quoka: QuokaConfig = field(default_factory=QuokaConfig)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.dtype

    @property
    def pattern(self) -> Tuple[str, ...]:
        return ("attn",)

    def stacks(self) -> Sequence[Tuple[Tuple[str, ...], int]]:
        """(period, n_repeats) groups; a dense decoder is one stack."""
        return [(self.pattern, self.n_layers)]

    def smoke(self, **overrides) -> "ModelConfig":
        """Reduced variant for CPU tests — the same reduction as the
        reference's ``ModelConfig.smoke`` for dense configs."""
        ch = dict(
            n_layers=min(self.n_layers, 2),
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            head_dim=64 if self.resolved_head_dim >= 64 else self.resolved_head_dim,
            dtype=torch.float32,
        )
        if self.n_kv_heads == self.n_heads:
            ch["n_kv_heads"] = ch["n_heads"]
        ch["quoka"] = dataclasses.replace(
            self.quoka, chunk_size=16, budget=32, n_queries=4, keep_first=2)
        ch.update(overrides)
        return dataclasses.replace(self, **ch)


def get_config(name: str) -> ModelConfig:
    from repro_torch.configs import granite_3_2b, qwen3_4b
    known = {"qwen3-4b": qwen3_4b.get_config,
             "granite-3-2b": granite_3_2b.get_config}
    key = name.replace("_", "-").replace(".", "-")
    if key not in known:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(known)}")
    return known[key]()
