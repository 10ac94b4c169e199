"""The port's model configs against the reference's (mirrors
``tests/test_configs.py`` for the configs the port holds).

Each config has its published dimensions and the reference's source, a
parameter count equal to the reference's and inside the published band,
stacks that cover every layer, and a small ``smoke()`` variant equal to the
reference's in every dimension the port reads.
"""
import pytest
import torch

from repro.configs import get_config as ref_config
from repro_torch.configs import get_config
from repro_torch.models.model import build_model

PORTED = ("qwen3-4b", "granite-3-2b", "llama3-2-3b", "stablelm-3b")

EXACT_DIMS = {  # (n_layers, d_model, n_heads, n_kv, head_dim, d_ff, vocab)
    "qwen3-4b": (36, 2560, 32, 8, 128, 9728, 151936),
    "granite-3-2b": (40, 2048, 32, 8, 64, 8192, 49155),
    "llama3-2-3b": (28, 3072, 24, 8, 128, 8192, 128256),
    "stablelm-3b": (32, 2560, 32, 32, 80, 6912, 50304),
}

PARAMS_B = {   # published total parameters (1e9), as a band
    "qwen3-4b": (3.6, 4.4),          # Qwen3-4B: 4.0 B
    "granite-3-2b": (2, 3.3),        # the reference's band
    "llama3-2-3b": (3.0, 3.5),       # Llama 3.2 3B: 3.21 B
    "stablelm-3b": (2, 3.5),         # the reference's band
}


def _dims(cfg):
    return (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab)


@pytest.mark.parametrize("arch", PORTED)
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


@pytest.mark.parametrize("arch", PORTED)
def test_param_counts_in_band(arch):
    lo, hi = PARAMS_B[arch]
    n = get_config(arch).param_count()
    assert n == ref_config(arch).param_count()
    assert lo <= n / 1e9 <= hi, f"{arch}: {n / 1e9:.2f}B outside [{lo}, {hi}]"


@pytest.mark.parametrize("arch", PORTED)
def test_stacks_cover_all_layers(arch):
    cfg = get_config(arch)
    assert sum(len(p) * r for p, r in cfg.stacks()) == cfg.n_layers
    assert {k for p, _ in cfg.stacks() for k in p} == {"attn"}


@pytest.mark.parametrize("arch", PORTED)
def test_smoke_variant_is_small_and_the_references(arch):
    s, rs = get_config(arch).smoke(), ref_config(arch).smoke()
    assert s.n_layers <= 2 and s.d_model <= 256 and s.vocab <= 512
    assert _dims(s) == _dims(rs)
    assert (s.n_heads == s.n_kv_heads) == \
        (get_config(arch).n_heads == get_config(arch).n_kv_heads)
    assert s.dtype == torch.float32
    # the built smoke model holds exactly the counted weight matrices
    model = build_model(s, device="cpu")
    mats = sum(p.numel() for p in model.parameters() if p.ndim == 2)
    assert mats == s.param_count()


def test_get_config_names():
    assert get_config("llama3.2-3b").name == "llama3-2-3b"
    assert get_config("stablelm_3b").name == "stablelm-3b"
    with pytest.raises(KeyError, match="ported"):
        get_config("olmoe-1b-7b")
