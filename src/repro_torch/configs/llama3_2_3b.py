"""llama3.2-3b — the paper's primary evaluation model (arXiv:2407.21783).

QUOKA's own experiments (Tables 1, 3; Figures 2, 4) use it.  28L
d_model=3072 24H (GQA kv=8, a group of 3) head_dim=128 d_ff=8192
vocab=128256.
"""
from repro_torch.configs.base import ModelConfig, QuokaConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=128256,
        rope_theta=500_000.0,
        quoka=QuokaConfig(chunk_size=128, budget=1024, n_queries=16),
        source="arXiv:2407.21783",
    )
