"""rwkv6-1.6b — Finch: attention-free, data-dependent decay
(arXiv:2404.05892).

24L d_model=2048 d_ff=7168 vocab=65536; head_dim 64 -> 32 wkv heads.  No
attention and no KV cache, so QUOKA has nothing to select: the model runs
on its recurrent state under every method.
"""
from repro_torch.configs.base import ModelConfig, QuokaConfig, RWKVConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,            # wkv heads = d_model / rwkv.head_dim
        n_kv_heads=32,
        d_ff=7168,
        vocab=65536,
        layer_pattern=("rwkv",),
        rwkv=RWKVConfig(head_dim=64, decay_lora=64),
        use_rope=False,
        act="relu2",
        quoka=QuokaConfig(chunk_size=128, budget=1024, n_queries=16),
        source="arXiv:2404.05892",
    )
