"""The port's model configs against the reference's (mirrors
``tests/test_configs.py`` for the configs the port holds).

Each config has its published dimensions and the reference's source, a
parameter count equal to the reference's and inside the published band,
stacks that cover every layer, and a small ``smoke()`` variant equal to the
reference's in every dimension the port reads.  The MoE and MLA configs
(olmoe-1b-7b, deepseek-v3-671b) also match the reference's expert and
latent geometry, layer groups, active-parameter count and smoke
reduction; the sliding-window configs (gemma3-27b, h2o-danube-3-4b) their
window, layer pattern and the smoke window min(window, 64); the recurrent
configs (zamba2-7b, rwkv6-1.6b) their SSM / RWKV geometry, layer pattern,
rope setting and smoke reduction; the modality configs (whisper-small,
internvl2-1b) their encoder and frontend geometry, norms, rope setting and
smoke reduction, with the reference's parameter count (which leaves out
the encoder and the projector and counts three MLP matrices where
whisper's MLP has two).
"""
import dataclasses

import pytest
import torch

from repro.configs import get_config as ref_config
from repro_torch.configs import get_config
from repro_torch.models.model import build_model

PORTED = ("qwen3-4b", "granite-3-2b", "llama3-2-3b", "stablelm-3b",
          "olmoe-1b-7b", "deepseek-v3-671b", "gemma3-27b", "h2o-danube-3-4b")
RECURRENT = ("zamba2-7b", "rwkv6-1.6b")
MODALITY = ("whisper-small", "internvl2-1b")

EXACT_DIMS = {  # (n_layers, d_model, n_heads, n_kv, head_dim, d_ff, vocab)
    "qwen3-4b": (36, 2560, 32, 8, 128, 9728, 151936),
    "granite-3-2b": (40, 2048, 32, 8, 64, 8192, 49155),
    "llama3-2-3b": (28, 3072, 24, 8, 128, 8192, 128256),
    "stablelm-3b": (32, 2560, 32, 32, 80, 6912, 50304),
    "olmoe-1b-7b": (16, 2048, 16, 16, 128, 1024, 50304),
    "deepseek-v3-671b": (61, 7168, 128, 128, 56, 18432, 129280),
    "gemma3-27b": (62, 5376, 32, 16, 128, 21504, 262144),
    "h2o-danube-3-4b": (24, 3840, 32, 8, 120, 10240, 32000),
    "zamba2-7b": (81, 3584, 32, 32, 112, 14336, 32000),
    "rwkv6-1.6b": (24, 2048, 32, 32, 64, 7168, 65536),
    "whisper-small": (12, 768, 12, 12, 64, 3072, 51865),
    "internvl2-1b": (24, 896, 14, 2, 64, 4864, 151655),
}

PARAMS_B = {   # published total parameters (1e9), as a band
    "qwen3-4b": (3.6, 4.4),          # Qwen3-4B: 4.0 B
    "granite-3-2b": (2, 3.3),        # the reference's band
    "llama3-2-3b": (3.0, 3.5),       # Llama 3.2 3B: 3.21 B
    "stablelm-3b": (2, 3.5),         # the reference's band
    "olmoe-1b-7b": (6, 8),           # OLMoE-1B-7B: 6.9 B
    "deepseek-v3-671b": (620, 720),  # DeepSeek-V3: 671 B
    "gemma3-27b": (25, 29),          # the reference's band (27.0 B)
    "h2o-danube-3-4b": (3, 4.6),     # the reference's band (3.84 B)
    "zamba2-7b": (5.5, 8.5),         # the reference's band (6.64 B)
    "rwkv6-1.6b": (0.9, 2.0),        # the reference's band (1.24 B)
    "whisper-small": (0.1, 0.35),    # the reference's band (0.181 B)
    "internvl2-1b": (0.3, 1.2),      # the reference's band (0.494 B)
}


def _dims(cfg):
    return (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab)


@pytest.mark.parametrize("arch", PORTED + RECURRENT + MODALITY)
def test_published_dimensions_and_source(arch):
    cfg, rc = get_config(arch), ref_config(arch)
    assert cfg.name == arch
    assert _dims(cfg) == EXACT_DIMS[arch] == _dims(rc)
    assert cfg.source and cfg.source == rc.source
    assert (cfg.rope_theta, cfg.tie_embeddings, cfg.norm_eps, cfg.act,
            cfg.use_rope) == (rc.rope_theta, rc.tie_embeddings, rc.norm_eps,
                              rc.act, rc.use_rope)
    assert (cfg.quoka.chunk_size, cfg.quoka.budget, cfg.quoka.n_queries) == \
        (rc.quoka.chunk_size, rc.quoka.budget, rc.quoka.n_queries)


@pytest.mark.parametrize("arch", PORTED + RECURRENT + MODALITY)
def test_param_counts_in_band(arch):
    lo, hi = PARAMS_B[arch]
    n = get_config(arch).param_count()
    assert n == ref_config(arch).param_count()
    assert lo <= n / 1e9 <= hi, f"{arch}: {n / 1e9:.2f}B outside [{lo}, {hi}]"


@pytest.mark.parametrize("arch", PORTED + RECURRENT + MODALITY)
def test_stacks_cover_all_layers(arch):
    cfg = get_config(arch)
    assert sum(len(p) * r for p, r in cfg.stacks()) == cfg.n_layers
    assert list(cfg.stacks()) == list(ref_config(arch).stacks())
    assert {k for p, _ in cfg.stacks() for k in p} <= \
        {"attn", "attn_local", "attn_moe", "mla", "mla_moe", "mamba",
         "mamba_shared_attn", "rwkv", "dec_cross"}


def _uncounted(cfg):
    """Weight matrices a built model holds beyond ``param_count``, whose
    reference counts no encoder and no projector and three MLP matrices
    where whisper's (gelu, ungated) MLP has two."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if cfg.family == "audio":
        attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
            + cfg.n_heads * hd * d
        return cfg.encoder.n_layers * (attn + 2 * d * cfg.d_ff) \
            - cfg.n_layers * d * cfg.d_ff
    if cfg.family == "vlm":
        return cfg.frontend.d_in * d + d * d
    return 0


@pytest.mark.parametrize("arch", PORTED + MODALITY)
def test_smoke_variant_is_small_and_the_references(arch):
    s, rs = get_config(arch).smoke(), ref_config(arch).smoke()
    assert s.n_layers <= 2 and s.d_model <= 256 and s.vocab <= 512
    assert _dims(s) == _dims(rs)
    assert (s.n_heads == s.n_kv_heads) == \
        (get_config(arch).n_heads == get_config(arch).n_kv_heads)
    assert s.dtype == torch.float32
    # the built smoke model holds exactly the counted weights (matrices
    # and expert / decompression stacks; the MTP head is not counted) and
    # those the reference's count leaves out
    model = build_model(s, device="cpu")
    mats = sum(p.numel() for n, p in model.named_parameters()
               if p.ndim >= 2 and not n.startswith("mtp."))
    assert mats == s.param_count() + _uncounted(s)
    assert (_uncounted(s) != 0) == (arch in MODALITY)


def test_get_config_names():
    assert get_config("llama3.2-3b").name == "llama3-2-3b"
    assert get_config("stablelm_3b").name == "stablelm-3b"
    assert get_config("olmoe_1b_7b").name == "olmoe-1b-7b"
    assert get_config("h2o_danube_3_4b").name == "h2o-danube-3-4b"
    assert get_config("zamba2_7b").name == "zamba2-7b"
    assert get_config("rwkv6_1.6b").name == "rwkv6-1.6b"
    assert get_config("whisper_small").name == "whisper-small"
    assert get_config("internvl2_1b").name == "internvl2-1b"
    with pytest.raises(KeyError, match="ported"):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_and_mla_geometry_match_reference(arch):
    """Expert and latent geometry, layer pattern and groups, MTP and the
    read-out tie equal the reference's; the active-parameter count (top-k
    and shared experts only) too, at full and smoke size."""
    cfg, rc = get_config(arch), ref_config(arch)
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(rc.moe)
    assert (dataclasses.asdict(cfg.mla) if cfg.mla else None) == \
        (dataclasses.asdict(rc.mla) if rc.mla else None)
    assert (cfg.family, cfg.layer_pattern, cfg.layer_groups, cfg.mtp,
            cfg.tie_embeddings) == (rc.family, rc.layer_pattern,
                                    rc.layer_groups, rc.mtp,
                                    rc.tie_embeddings)
    for c, r in ((cfg, rc), (cfg.smoke(), rc.smoke())):
        assert c.active_param_count() == r.active_param_count()
        assert c.param_count() == r.param_count()
    assert cfg.active_param_count() < cfg.param_count()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_and_mla_smoke_reduction_matches_reference(arch):
    """smoke(): 4 experts, top-2, d_expert <= 256, dense dispatch, the MLA
    smoke ranks with head_dim 0, and layer groups reduced to the first two
    kinds as one pattern."""
    s, rs = get_config(arch).smoke(), ref_config(arch).smoke()
    assert dataclasses.asdict(s.moe) == dataclasses.asdict(rs.moe)
    assert s.moe.dispatch == "dense" and s.moe.n_experts == 4
    assert (dataclasses.asdict(s.mla) if s.mla else None) == \
        (dataclasses.asdict(rs.mla) if rs.mla else None)
    assert (s.layer_pattern, s.layer_groups, s.n_layers, s.head_dim) == \
        (rs.layer_pattern, rs.layer_groups, rs.n_layers, rs.head_dim)
    assert list(s.stacks()) == list(rs.stacks())


@pytest.mark.parametrize("arch", ["gemma3-27b", "h2o-danube-3-4b"])
def test_window_geometry_matches_reference(arch):
    """The window, the layer pattern and the stacks (gemma3: ten periods of
    5 local + 1 global and a one-repeat tail of 2 local layers), and the
    smoke reduction (window min(window, 64), a pattern that keeps one of
    each kind) equal the reference's."""
    cfg, rc = get_config(arch), ref_config(arch)
    assert (cfg.sliding_window, cfg.layer_pattern, cfg.family) == \
        (rc.sliding_window, rc.layer_pattern, rc.family)
    assert list(cfg.stacks()) == list(rc.stacks())
    s, rs = cfg.smoke(), rc.smoke()
    assert s.sliding_window == rs.sliding_window == min(cfg.sliding_window,
                                                        64)
    assert (s.layer_pattern, s.n_layers) == (rs.layer_pattern, rs.n_layers)
    assert list(s.stacks()) == list(rs.stacks())
    if arch == "gemma3-27b":
        assert list(cfg.stacks()) == [
            (("attn_local",) * 5 + ("attn",), 10),
            (("attn_local", "attn_local"), 1)]
        assert s.layer_pattern == ("attn_local", "attn")
    assert get_config("qwen3-4b").sliding_window is None


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_geometry_and_smoke_match_reference(arch):
    """The SSM / RWKV geometry, family, layer pattern and rope setting equal
    the reference's (zamba2: stacks of 13 periods of 5 mamba + 1
    mamba_shared_attn and a one-repeat tail of 3 mamba; rwkv6: no rope,
    squared ReLU), and so do the smoke reductions (d_state 16 and head dim
    32; RWKVConfig(32, 16); a pattern that keeps one of each kind) and
    their parameter counts, the shared block counted once."""
    cfg, rc = get_config(arch), ref_config(arch)
    for c, r in ((cfg, rc), (cfg.smoke(), rc.smoke())):
        assert (dataclasses.asdict(c.ssm) if c.ssm else None) == \
            (dataclasses.asdict(r.ssm) if r.ssm else None)
        assert (dataclasses.asdict(c.rwkv) if c.rwkv else None) == \
            (dataclasses.asdict(r.rwkv) if r.rwkv else None)
        assert (c.family, c.layer_pattern, c.use_rope, c.act, c.n_layers) \
            == (r.family, r.layer_pattern, r.use_rope, r.act, r.n_layers)
        assert list(c.stacks()) == list(r.stacks())
        assert c.param_count() == r.param_count()
    s = cfg.smoke()
    assert _dims(s) == _dims(rc.smoke()) and s.dtype == torch.float32
    if arch == "zamba2-7b":
        assert (cfg.family, cfg.ssm.d_state, cfg.ssm.head_dim) == \
            ("hybrid", 64, 64)
        assert list(cfg.stacks()) == [
            (("mamba",) * 5 + ("mamba_shared_attn",), 13),
            (("mamba",) * 3, 1)]
        assert (s.ssm.d_state, s.ssm.head_dim) == (16, 32)
        assert s.layer_pattern == ("mamba", "mamba_shared_attn")
        # the shared block once: its attention and MLP terms
        d, hd = cfg.d_model, cfg.resolved_head_dim
        shared = d * hd * 3 * 32 + 32 * hd * d + 3 * d * cfg.d_ff
        unshared = dataclasses.replace(
            cfg, layer_pattern=("mamba",)).param_count()
        assert cfg.param_count() == unshared + shared
    else:
        assert (cfg.family, cfg.use_rope, cfg.act) == ("ssm", False, "relu2")
        assert (s.rwkv.head_dim, s.rwkv.decay_lora) == (32, 16)


@pytest.mark.parametrize("arch", MODALITY)
def test_modality_geometry_and_smoke_match_reference(arch):
    """The encoder and frontend geometry, family, layer pattern, act, rope
    setting and read-out tie equal the reference's at full and smoke size
    (the smoke encoder 2 layers over 64 frames; the frontend 16 tokens of
    d_in min(d_in, 128)), and so do the stacks and parameter counts.  The
    port holds only the fields it reads: no encoder width or heads (the
    decoder's), no frontend kind, and no frontend for whisper (its frames
    are the encoder's n_ctx rows of d_model)."""
    cfg, rc = get_config(arch), ref_config(arch)

    def fields(port, ref):
        return None if port is None else [
            (f.name, getattr(port, f.name), getattr(ref, f.name))
            for f in dataclasses.fields(port)]

    for c, r in ((cfg, rc), (cfg.smoke(), rc.smoke())):
        assert (c.encoder is None) == (r.encoder is None)
        if c.encoder is not None:
            assert (r.encoder.d_model, r.encoder.n_heads) == (0, 0)
        assert (c.frontend is None) == (c.family == "audio")
        for group in (fields(c.encoder, r.encoder),
                      fields(c.frontend, r.frontend)):
            for name, mine, theirs in group or ():
                assert mine == theirs, name
        assert c.prefix_positions == (
            r.frontend.n_tokens if r.family == "vlm" else 0)
        assert (c.family, c.layer_pattern, c.use_rope, c.act, c.n_layers,
                c.tie_embeddings, c.rope_theta) == \
            (r.family, r.layer_pattern, r.use_rope, r.act, r.n_layers,
             r.tie_embeddings, r.rope_theta)
        assert list(c.stacks()) == list(r.stacks())
        assert c.param_count() == r.param_count()
    s = cfg.smoke()
    assert _dims(s) == _dims(rc.smoke()) and s.dtype == torch.float32
    if arch == "whisper-small":
        # the reference's full-size frontend restates the encoder's input
        assert (rc.frontend.n_tokens, rc.frontend.d_in) == \
            (cfg.encoder.n_ctx, cfg.d_model)
        assert cfg.param_count() == 181_390_080
        assert (cfg.family, cfg.use_rope, cfg.act) == ("audio", False, "gelu")
        assert (cfg.encoder.n_layers, cfg.encoder.n_ctx) == (12, 1500)
        assert (s.encoder.n_layers, s.encoder.n_ctx) == (2, 64)
        assert cfg.quoka.budget == 512
        assert list(cfg.stacks()) == [(("dec_cross",), 12)]
    else:
        assert cfg.param_count() == 493_709_440
        assert (cfg.family, cfg.encoder) == ("vlm", None)
        assert (cfg.frontend.n_tokens, cfg.frontend.d_in) == (256, 1024)
        assert (s.frontend.n_tokens, s.frontend.d_in) == (16, 128)
        assert cfg.n_heads // cfg.n_kv_heads == 7
