"""whisper-small — an encoder-decoder; the conv / mel frontend is a stub
(arXiv:2212.04356).

12L (decoder) d_model=768 12H (MHA, kv=12) head_dim=64 d_ff=3072
vocab=51865; a 12-layer encoder over 1500 stub frame embeddings.
Sinusoidal positions (no rope), gelu MLPs, LayerNorm in the blocks.  QUOKA
selects on the decoder's self-attention; cross-attention and the
bidirectional encoder (one pass, no cache) attend densely.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig, QuokaConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab=51865,
        layer_pattern=("dec_cross",),
        encoder=EncoderConfig(n_layers=12, n_ctx=1500),
        use_rope=False,
        act="gelu",
        tie_embeddings=True,
        quoka=QuokaConfig(chunk_size=128, budget=512, n_queries=16),
        source="arXiv:2212.04356",
    )
