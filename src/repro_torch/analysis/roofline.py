"""Three-term roofline model (counterpart of ``repro/analysis/roofline.py``).

    compute    = FLOPs       / (chips x peak_FLOP/s)
    memory     = bytes       / (chips x HBM_bw)
    collective = coll_bytes  / (chips x link_bw)

Hardware constants: NVIDIA H100 SXM, from its public data sheet — 989
TFLOP/s dense bf16 tensor-core peak, 3.35 TB/s HBM3, NVLink 900 GB/s in
total, 450 GB/s per direction.  They are data-sheet peaks, not
measurements: a card set below its 700 W limit runs slower under load.
``chip_smoke.py``'s bounds and ``launch/train.py``'s model-FLOP share read
them from here.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) per training step; for
inference steps the factor is 2·N·D (forward only).  The ratio
MODEL_FLOPS / FLOPs flags recompute and redundancy.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional

PEAK_FLOPS = 989e12          # bf16 dense, per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per card, NVLink, one direction


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_ratio: float      # MODEL_FLOPS / FLOPs
    bytes_per_chip: float    # peak memory per card
    note: str = ""

    def as_dict(self) -> Dict:
        return asdict(self)


def analyse(arch: str, shape: str, mesh_name: str, chips: int,
            cost: Dict, coll: Dict, model_flops: float,
            bytes_per_chip: float = 0.0, note: str = "") -> Roofline:
    """``cost`` ({"flops", "bytes"}) and ``coll`` ({"coll_total"}) are PER
    CARD; ``model_flops`` is GLOBAL.  The field names keep the reference's
    (``hlo_*``) whatever the counts' source."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes", cost.get("bytes accessed", 0.0)))
    cb = float(coll.get("coll_total", coll.get("total", 0.0)))
    t_c = flops / PEAK_FLOPS
    t_m = byts / HBM_BW
    t_x = cb / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bn = max(terms, key=terms.get)
    total_flops = flops * chips
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=byts, coll_bytes=cb,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bn, model_flops=model_flops,
        useful_ratio=(model_flops / total_flops) if total_flops else 0.0,
        bytes_per_chip=bytes_per_chip, note=note)


def model_flops(cfg, shape_kind: str, batch: int, seq: int,
                budget: Optional[int] = None) -> float:
    """Analytic 'useful' FLOPs for the step.

    train: 6·N_active·tokens.  prefill: 2·N_active·tokens (+ attention term).
    decode: 2·N_active·batch (one token each).
    Attention FLOPs are added explicitly since 6ND ignores them:
      train/full prefill: 2·2·L·H·hd·T²/2 per sequence (causal half);
      quoka prefill: T·(B_SA+B_CP) instead of T²/2;
      decode: T (or budget) per token.
    """
    n = cfg.active_param_count()
    toks = batch * seq
    hd = cfg.resolved_head_dim
    att_layers = sum(1 for pd, r in cfg.stacks() for k in pd * r
                     if k not in ("rwkv", "mamba"))
    if shape_kind == "train":
        base = 6.0 * n * toks
        att = 3 * 2 * 2 * att_layers * cfg.n_heads * hd * batch * seq * seq / 2
        return base + att
    if shape_kind == "prefill":
        base = 2.0 * n * toks
        bsa = budget or cfg.quoka.budget
        eff = min(seq, bsa + cfg.quoka.chunk_size)
        att = 2 * 2 * att_layers * cfg.n_heads * hd * batch * seq * eff
        return base + att
    if shape_kind == "decode":
        base = 2.0 * n * batch
        bsa = budget or cfg.quoka.budget
        eff = min(seq, bsa + 1)
        att = 2 * 2 * att_layers * cfg.n_heads * hd * batch * eff
        return base + att
    raise ValueError(shape_kind)
