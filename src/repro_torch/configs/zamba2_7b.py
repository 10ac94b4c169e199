"""zamba2-7b — a Mamba2 backbone with one shared attention block
(arXiv:2411.15242).

81L d_model=3584 32H (MHA, kv=32) head_dim=112 d_ff=14336 ssm_state=64.
Every 6th layer applies, after its Mamba2 mixer, the single SHARED
attention + MLP block (one set of weights, its own KV cache per use).
QUOKA selects on the shared block's KV caches; the Mamba2 blocks are
attention-free.
"""
from repro_torch.configs.base import ModelConfig, QuokaConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab=32000,
        layer_pattern=("mamba",) * 5 + ("mamba_shared_attn",),
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
        rope_theta=10_000.0,
        quoka=QuokaConfig(chunk_size=128, budget=1024, n_queries=16),
        source="arXiv:2411.15242",
    )
