"""qwen3-4b — the paper's latency-evaluation model (arXiv:2505.09388).

36L d_model=2560 32H (GQA kv=8) head_dim=128 d_ff=9728 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, QuokaConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab=151936,
        rope_theta=1_000_000.0,
        quoka=QuokaConfig(chunk_size=128, budget=1024, n_queries=16),
        source="arXiv:2505.09388",
    )
