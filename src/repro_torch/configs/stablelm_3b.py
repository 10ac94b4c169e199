"""stablelm-3b [dense] — MHA (kv=32) decoder (hf:stabilityai/stablelm-2-1_6b).

32L d_model=2560 32H (kv=32) head_dim=80 d_ff=6912 vocab=50304.  n_q ==
n_kv, so QUOKA's GQA pre-aggregation is the identity (still exact).
"""
from repro_torch.configs.base import ModelConfig, QuokaConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=6912,
        vocab=50304,
        rope_theta=10_000.0,
        quoka=QuokaConfig(chunk_size=128, budget=1024, n_queries=16),
        source="hf:stabilityai/stablelm-2-1_6b",
    )
