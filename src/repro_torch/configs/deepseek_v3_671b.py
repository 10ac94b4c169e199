"""deepseek-v3-671b — MLA + 256-expert top-8 MoE + MTP (arXiv:2412.19437).

61L d_model=7168 128H.  The first 3 layers use a dense FFN (d_ff 18432),
the other 58 one shared + 256 routed experts (d_expert 2048), top-8.  MLA:
q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64, v 128 — the KV cache
holds only the 512-wide latent and the 64-wide rope key per token.
Untied read-out; the MTP head's parameters are held (a training-time loss).
"""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      QuokaConfig)


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_ff=18432,                       # dense layers' FFN
        vocab=129280,
        layer_groups=((("mla",), 3), (("mla_moe",), 58)),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                      dispatch="capacity"),
        mtp=True,
        rope_theta=10_000.0,
        tie_embeddings=False,
        quoka=QuokaConfig(chunk_size=128, budget=1024, n_queries=16),
        source="arXiv:2412.19437",
    )
