"""h2o-danube-3-4b — a llama / mistral mix with sliding-window attention
on every layer (arXiv:2401.16818).

24L d_model=3840 32H (GQA kv=8) head_dim=120 d_ff=10240 vocab=32000;
mistral-style windows of 4096 keys.  QUOKA selects inside the window
(budget 1024 < 4096), scoring a ring whose slots wrap.
"""
from repro_torch.configs.base import ModelConfig, QuokaConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        head_dim=120,
        d_ff=10240,
        vocab=32000,
        sliding_window=4096,
        layer_pattern=("attn_local",),
        rope_theta=10_000.0,
        quoka=QuokaConfig(chunk_size=128, budget=1024, n_queries=16),
        source="arXiv:2401.16818",
    )
