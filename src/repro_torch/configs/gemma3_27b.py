"""gemma3-27b — 5 : 1 local : global attention (hf:google/gemma-3-1b-pt
family, scaled to 27B).

62L d_model=5376 32H (GQA kv=16) head_dim=128 d_ff=21504 vocab=262144.
Five sliding-window layers (window 1024) per global layer; the 62 layers
are ten 6-layer periods and a tail of two local layers.  QUOKA selects on
the global layers only: a local layer's ring of 1024 slots is within
budget + chunk, so it attends its window densely.
"""
from repro_torch.configs.base import ModelConfig, QuokaConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab=262144,
        sliding_window=1024,
        layer_pattern=("attn_local",) * 5 + ("attn",),
        rope_theta=1_000_000.0,
        quoka=QuokaConfig(chunk_size=128, budget=2048, n_queries=16),
        source="hf:google/gemma-3-1b-pt",
    )
