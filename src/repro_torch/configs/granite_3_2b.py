"""granite-3-2b [dense] — GQA decoder (hf:ibm-granite/granite-3.0-2b-base).

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
"""
from repro_torch.configs.base import ModelConfig, QuokaConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        family="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab=49155,
        rope_theta=10_000.0,
        quoka=QuokaConfig(chunk_size=128, budget=1024, n_queries=16),
        source="hf:ibm-granite/granite-3.0-2b-base",
    )
