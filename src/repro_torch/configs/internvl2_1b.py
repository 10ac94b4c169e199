"""internvl2-1b — InternViT (a stub) and an InternLM2-style decoder
(arXiv:2404.16821).

24L d_model=896 14H (GQA kv=2) head_dim=64 d_ff=4864 vocab=151655.  The
vision frontend is a stub: the batch brings 256 precomputed patch
embeddings (d=1024), which the model's projector (a 2-layer MLP) maps
into the LM's embedding space ahead of the text tokens.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, QuokaConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab=151655,
        frontend=FrontendConfig(n_tokens=256, d_in=1024),
        rope_theta=1_000_000.0,
        quoka=QuokaConfig(chunk_size=128, budget=1024, n_queries=16),
        source="arXiv:2404.16821",
    )
