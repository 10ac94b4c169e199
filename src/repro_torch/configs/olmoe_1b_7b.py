"""olmoe-1b-7b — 64 experts, top-8 (arXiv:2409.02060).

16L d_model=2048 16H (MHA, kv=16) head_dim=128, expert d_ff=1024,
vocab=50304, tied embeddings, capacity dispatch.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, QuokaConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1024,
        vocab=50304,
        layer_pattern=("attn_moe",),
        moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024,
                      dispatch="capacity"),
        rope_theta=10_000.0,
        quoka=QuokaConfig(chunk_size=128, budget=1024, n_queries=16),
        source="arXiv:2409.02060",
    )
