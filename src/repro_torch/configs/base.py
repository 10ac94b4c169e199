"""Config dataclasses for the port (counterpart of ``repro/configs/base.py``).

Ported block kinds: ``"attn"`` (dense GQA attention + SwiGLU MLP),
``"attn_local"`` (sliding-window GQA attention + SwiGLU MLP),
``"attn_moe"`` (GQA attention + MoE FFN), ``"mla"`` (DeepSeek multi-head
latent attention + SwiGLU MLP), ``"mla_moe"`` (MLA + MoE FFN), ``"mamba"``
(Mamba2 SSD block), ``"mamba_shared_attn"`` (Mamba2 then zamba2's one
shared attention block), ``"rwkv"`` (RWKV6 time-mix + channel-mix),
``"enc_attn"`` (bidirectional attention + MLP: whisper's encoder) and
``"dec_cross"`` (causal self-attention, cross-attention over the
encoder's output, then the MLP: whisper's decoder); families
``"dense"``, ``"moe"``, ``"hybrid"``, ``"ssm"``, ``"audio"`` (whisper:
an encoder over stub frame embeddings) and ``"vlm"`` (internvl2: a
projector of stub patch embeddings).  Field names
and defaults match the reference so a test can build the same
configuration in both packages; dtypes are torch dtypes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int               # per-expert FFN hidden dim
    n_shared: int = 0           # shared (always-on) experts, deepseek-style
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    # "dense" = weighted sum over all experts (exact, smoke-test scale);
    # "capacity" = scatter/gather dispatch with fixed capacity (production).
    dispatch: str = "dense"


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2             # d_inner = expand * d_model
    head_dim: int = 64          # mamba2 head dim


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64        # rank of the data-dependent decay LoRA


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder over a (stubbed) conv/mel frontend: its
    frames are ``(b, n_ctx, d_model)`` and its layers have the decoder's
    width and heads (the reference's ``d_model`` / ``n_heads`` overrides,
    which nothing reads, are left out)."""
    n_layers: int
    n_ctx: int = 1500           # frames after the conv frontend


@dataclass(frozen=True)
class FrontendConfig:
    """A VLM's stub vision frontend: the batch brings its patch
    embeddings, which take ``n_tokens`` positions ahead of the prompt's.
    (Whisper's frames are the encoder's: ``EncoderConfig``.)"""
    n_tokens: int               # patches
    d_in: int                   # embedding dim the stub produces


@dataclass(frozen=True)
class QuokaConfig:
    """Paper Algorithm 1/2 hyper-parameters."""
    chunk_size: int = 128          # B_CP
    budget: int = 1024             # B_SA
    # B_SA as a fraction of the (static) cache capacity (paper Table 2)
    budget_ratio: Optional[float] = None
    n_queries: int = 16            # N_Q
    scoring: str = "cosine"        # "cosine" | "dot"   (Table 9 ablation)
    query_agg: str = "max"         # "max" | "mean"     (Table 10 ablation)
    keep_first: int = 4            # sink tokens always kept
    method: str = "quoka"
    # method-specific knobs for the baselines
    rank: int = 64                 # SparQ / Loki down-projection dim
    # selection granularity in tokens: 1 = per-token top-k, >1 = blocks of
    # g tokens shared across KV heads (core/plan.py)
    granularity: int = 1
    # cross-layer plan reuse: score every ``reuse_interval`` layers and
    # reuse the last plan in between; correction layers always re-score
    reuse_interval: int = 1
    correction_layers: Tuple[int, ...] = ()
    # low-rank scoring: project q̄ and K to this dim before the scoring
    # kernel (kernels/ops.py::score_projection); 0 = full head dim
    score_proj_dim: int = 0
    # route block-granular selection onto the fused selected-attention
    # kernel instead of materialize + attention (core/plan.py::fused_route)
    fused_select_attn: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str
    # "dense" | "moe" | "hybrid" | "ssm" | "audio" | "vlm"
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    use_rope: bool = True
    rope_theta: float = 10_000.0
    # keys an ``attn_local`` layer attends back (its ring cache's length)
    sliding_window: Optional[int] = None
    # repeating block pattern; None -> one kind, collapsed to one period
    # (gemma3: ("attn_local",) * 5 + ("attn",))
    layer_pattern: Optional[Tuple[str, ...]] = None
    # explicit ((period, n_repeats), ...) for non-periodic stacks, e.g.
    # deepseek-v3: ((("mla",), 3), (("mla_moe",), 58))
    layer_groups: Optional[Tuple[Tuple[Tuple[str, ...], int], ...]] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[FrontendConfig] = None
    mtp: bool = False              # deepseek multi-token-prediction head
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"
    dtype: torch.dtype = torch.bfloat16
    source: str = ""
    quoka: QuokaConfig = field(default_factory=QuokaConfig)
    remat: bool = False            # recompute each layer in the backward

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.dtype

    @property
    def prefix_positions(self) -> int:
        """Cache positions the frontend puts before the prompt's tokens: a
        VLM's patches (whisper's frames go to its encoder, not the cache)."""
        return self.frontend.n_tokens if self.frontend is not None else 0

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern is not None:
            return self.layer_pattern
        base = "attn_moe" if self.moe is not None else "attn"
        if self.mla is not None:
            base = "mla_moe" if self.moe is not None else "mla"
        return (base,)

    def stacks(self) -> Sequence[Tuple[Tuple[str, ...], int]]:
        """Partition n_layers into (period, n_repeats) groups: the explicit
        ``layer_groups``, else the pattern repeated with the tail
        (n_layers % len(pattern)) a single-repeat stack of its own."""
        if self.layer_groups is not None:
            if sum(len(p) * r for p, r in self.layer_groups) != self.n_layers:
                raise ValueError(f"{self.name}: layer_groups do not sum to "
                                 f"{self.n_layers} layers")
            return list(self.layer_groups)
        pat = self.pattern
        reps, rem = divmod(self.n_layers, len(pat))
        out = []
        if reps:
            out.append((pat, reps))
        if rem:
            out.append((pat[:rem], 1))
        return out

    def layer_kinds(self) -> Tuple[str, ...]:
        """Every layer's block kind, in order."""
        return tuple(k for period, r in self.stacks() for k in period * r)

    def param_count(self) -> int:
        """Weight-matrix parameters (embedding and read-out, attention
        projections, MLP or experts and router; norms left out), counted
        as the reference's ``param_count`` counts them, quirks included:
        the MTP head, whisper's encoder and internvl2's projector are not
        counted; an MLP counts three matrices even where it has two (an
        ungated gelu MLP), and a ``dec_cross`` layer counts two attention
        blocks (self and cross); ``rwkv`` and ``mamba`` have their own
        approximate terms, and zamba2's shared block counts once."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds():
            p = 0
            if kind in ("attn", "attn_local", "attn_moe"):
                p += attn
            if kind == "dec_cross":
                p += 2 * attn
            if kind in ("mla", "mla_moe"):
                m = self.mla
                qk = m.qk_nope_dim + m.qk_rope_dim
                p += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                p += d * (m.kv_lora_rank + m.qk_rope_dim)
                p += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim
                                                      + m.v_head_dim)
                p += self.n_heads * m.v_head_dim * d
            if kind in ("attn", "attn_local", "mla", "dec_cross"):
                p += 3 * d * self.d_ff
            if kind in ("attn_moe", "mla_moe"):
                e = self.moe
                p += d * e.n_experts                       # router
                p += e.n_experts * 3 * d * e.d_expert
                p += e.n_shared * 3 * d * (e.d_expert if self.mla
                                           else self.d_ff)
            if kind == "rwkv":
                p += 4 * d * d + d * self.d_ff * 2
            if kind in ("mamba", "mamba_shared_attn"):
                di = self.ssm.expand * d
                p += d * 2 * di + di * d + 2 * di * self.ssm.d_state
            total += p
        if "mamba_shared_attn" in self.layer_kinds():
            total += attn + 3 * d * self.d_ff
        return int(total)

    def active_param_count(self) -> int:
        """Parameters active per token: a MoE layer counts its top-k and
        shared experts only."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        n_moe = sum(k in ("attn_moe", "mla_moe") for k in self.layer_kinds())
        inactive = n_moe * (e.n_experts - e.top_k) * 3 * self.d_model \
            * e.d_expert
        return int(self.param_count() - inactive)

    def smoke(self, **overrides) -> "ModelConfig":
        """Reduced variant for CPU tests — the same reduction as the
        reference's ``ModelConfig.smoke`` for the ported kinds."""
        ch = dict(
            n_layers=min(self.n_layers, 2),
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            head_dim=64 if self.resolved_head_dim >= 64 else self.resolved_head_dim,
            dtype=torch.float32,
        )
        if self.n_kv_heads == self.n_heads:
            ch["n_kv_heads"] = ch["n_heads"]
        if self.layer_groups is not None:
            # the first two distinct kinds (deepseek: ("mla", "mla_moe"))
            kinds = tuple(dict.fromkeys(
                k for period, _ in self.layer_groups for k in period))
            pat = kinds[:2] if len(kinds) >= 2 else kinds * 2
            ch["layer_groups"] = None
            ch["layer_pattern"] = pat
            ch["n_layers"] = len(pat)
        elif self.layer_pattern is not None:
            pat = self.layer_pattern[-ch["n_layers"]:]
            # keep at least one of each distinct block kind if possible
            kinds = tuple(dict.fromkeys(self.layer_pattern))
            if len(kinds) > 1 and len(set(pat)) < len(kinds):
                pat = kinds[:ch["n_layers"]]
            while len(pat) < ch["n_layers"]:
                pat = pat + (pat[-1],)
            ch["layer_pattern"] = pat
            ch["n_layers"] = len(pat)
        if self.moe is not None:
            ch["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_expert=min(self.moe.d_expert, 256), dispatch="dense")
        if self.mla is not None:
            ch["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                  qk_nope_dim=32, qk_rope_dim=16,
                                  v_head_dim=32)
            ch["head_dim"] = 0
        if self.ssm is not None:
            ch["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=32)
        if self.rwkv is not None:
            ch["rwkv"] = RWKVConfig(head_dim=32, decay_lora=16)
        if self.encoder is not None:
            ch["encoder"] = dataclasses.replace(self.encoder, n_layers=2,
                                                n_ctx=64)
        if self.frontend is not None:
            ch["frontend"] = dataclasses.replace(
                self.frontend, n_tokens=16, d_in=min(self.frontend.d_in, 128))
        if self.sliding_window is not None:
            ch["sliding_window"] = min(self.sliding_window, 64)
        ch["quoka"] = dataclasses.replace(
            self.quoka, chunk_size=16, budget=32, n_queries=4, keep_first=2)
        ch.update(overrides)
        return dataclasses.replace(self, **ch)


def get_config(name: str) -> ModelConfig:
    from repro_torch.configs import (deepseek_v3_671b, gemma3_27b,
                                     granite_3_2b, h2o_danube_3_4b,
                                     internvl2_1b, llama3_2_3b, olmoe_1b_7b,
                                     qwen3_4b, rwkv6_1_6b, stablelm_3b,
                                     whisper_small, zamba2_7b)
    known = {"qwen3-4b": qwen3_4b.get_config,
             "granite-3-2b": granite_3_2b.get_config,
             "llama3-2-3b": llama3_2_3b.get_config,
             "stablelm-3b": stablelm_3b.get_config,
             "olmoe-1b-7b": olmoe_1b_7b.get_config,
             "deepseek-v3-671b": deepseek_v3_671b.get_config,
             "gemma3-27b": gemma3_27b.get_config,
             "h2o-danube-3-4b": h2o_danube_3_4b.get_config,
             "zamba2-7b": zamba2_7b.get_config,
             "rwkv6-1-6b": rwkv6_1_6b.get_config,
             "whisper-small": whisper_small.get_config,
             "internvl2-1b": internvl2_1b.get_config}
    key = name.replace("_", "-").replace(".", "-")
    if key not in known:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(known)}")
    return known[key]()
