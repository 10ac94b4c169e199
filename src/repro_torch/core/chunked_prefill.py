"""Model-free chunked-prefill sparse attention (paper Algorithm 2) for one
attention layer (counterpart of ``repro/core/chunked_prefill.py``).

Given a layer's full-sequence Q, K, V, run chunked prefill with any
selection method and return every position's attention output: the
harness behind the accuracy proxies (output error against dense causal
attention, key recall against the oracle's top keys) and the equivalence
check (budget >= T gives dense causal attention).

Torch has no scan: the chunks run in a Python loop.  Dispatch is by the
tensors' device as everywhere in the port: on the card the staged chunk
attends through the flash kernel and the fused chunk through the
selected-attention kernel (scoring through the scoring kernel for
``quoka``); on the CPU their plain versions run.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import QuokaConfig
from repro_torch.core import plan as plan_mod
from repro_torch.core.attention import attention_with_positions
from repro_torch.core.quoka import topk_stable
from repro_torch.kernels import ops as kops


def _positions(b: int, t: int, device):
    return torch.arange(t, dtype=torch.int32, device=device)[None].repeat(
        b, 1)


def dense_causal_reference(q, k, v):
    """Oracle: full causal attention.  q (b, T, h, d), k, v (b, T, n_kv, d).
    Plain torch; past 2048 keys it streams 1024-key blocks, so the
    (b, h, T, T) fp32 logits are never whole (8 GiB at b = 1, h = 32,
    T = 8192)."""
    pos = _positions(q.shape[0], q.shape[1], q.device)
    return attention_with_positions(q, k, v, pos, pos, causal=True)


def chunked_sparse_attention(q, k, v, cfg: QuokaConfig,
                             method: Optional[str] = None):
    """Chunked prefill with per-chunk KV selection.

    q (b, T, h, d); k, v (b, T, n_kv, d); T a multiple of the chunk size.
    Returns (b, T, h, d): each chunk's softmax over [selected budget |
    causal chunk].  ``full`` is the dense oracle."""
    method = method or cfg.method
    b, t, h, d = q.shape
    n_kv = k.shape[2]
    bcp = min(cfg.chunk_size, t)
    if t % bcp:
        raise ValueError(f"sequence length {t} must be a multiple of {bcp}")
    if method == "full":
        return dense_causal_reference(q, k, v)
    pos_all = _positions(b, t, q.device)
    fused = plan_mod.fused_route(cfg, method, k)
    chunk_valid = torch.ones((b, n_kv, bcp), dtype=torch.bool,
                             device=q.device)
    outs = []
    for start in range(0, t, bcp):
        qc = q[:, start:start + bcp]
        if fused:
            # the plan's block ids drive the kernel, which reads the chunk
            # KV from the full view at [start, start + B_CP)
            pln = plan_mod.build(method, qc, k, pos_all, start, cfg)
            outs.append(kops.selected_attention(
                qc, k, v, pos_all, pln.idx, start,
                granularity=plan_mod.grid(cfg)))
            continue
        # staged: [selected budget | chunk]; the budget is an unconditioned
        # prefix (``boundary``), its padding masked per KV head
        sel = plan_mod.select(method, qc, k, v, pos_all, start, cfg)
        k_cat = torch.cat([sel.k, k[:, start:start + bcp]], dim=1)
        v_cat = torch.cat([sel.v, v[:, start:start + bcp]], dim=1)
        k_valid = torch.cat([sel.pos >= 0, chunk_valid], dim=-1)
        outs.append(kops.attention(qc, k_cat, v_cat, k_valid, causal=True,
                                   boundary=sel.pos.shape[-1]))
    return torch.cat(outs, dim=1)


def output_error(q, k, v, cfg: QuokaConfig, method: str):
    """Relative L2 error against the dense causal oracle (paper eq. (4)),
    a () fp32 tensor."""
    ref = dense_causal_reference(q, k, v)
    out = chunked_sparse_attention(q, k, v, cfg, method)
    num = torch.linalg.norm((out - ref).float())
    return num / (torch.linalg.norm(ref.float()) + 1e-9)


def _oracle_probs(q, k, start: int, pos_all):
    """Softmax of the queries from ``start`` on over the prior context
    (b, h, T - start, T), fp32."""
    b, t, h, d = q.shape
    n_kv = k.shape[2]
    mask = pos_all[:, None, None, :] < start
    kr = k.repeat_interleave(h // n_kv, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", q[:, start:].float(),
                          kr.float()) / math.sqrt(d)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    return torch.softmax(logits, dim=-1)


def _last_start(cfg: QuokaConfig, t: int) -> int:
    return t - min(cfg.chunk_size, t)


def _last_chunk_selection(q, k, v, cfg: QuokaConfig, method: str):
    b, t = q.shape[:2]
    start = _last_start(cfg, t)
    return plan_mod.select(method, q[:, start:], k, v,
                           _positions(b, t, q.device), start, cfg)


def key_recall(q, k, v, cfg: QuokaConfig, method: str, oracle: str = "max"):
    """Share of the oracle's top-B keys that the method selects for the
    last chunk (the hardest selection), a () tensor.

    oracle="max": a key's criticality is its largest softmax probability
    over the chunk queries and the GQA group ('decisive for any query', the
    NIAH criterion); "mean": the summed mass, averaged over the group."""
    b, t, h, d = q.shape
    n_kv = k.shape[2]
    sel = _last_chunk_selection(q, k, v, cfg, method)
    probs = _oracle_probs(q, k, _last_start(cfg, t),
                          _positions(b, t, q.device))
    if oracle == "max":
        mass = probs.amax(2).reshape(b, n_kv, h // n_kv, t).amax(2)
    else:
        mass = probs.sum(2).reshape(b, n_kv, h // n_kv, t).mean(2)
    budget = sel.pos.shape[-1]
    _, true_top = topk_stable(mass, budget)                       # (b,kv,B)
    hit = (sel.pos[..., :, None] == true_top[..., None, :]).any(-1)
    return (hit & (sel.pos >= 0)).sum() / true_top.numel()


def critical_keys(q, k, cfg: QuokaConfig, tau: float = 0.08):
    """bool (b, n_kv, T): keys that get at least ``tau`` softmax probability
    from some last-chunk query of their GQA group (the needle
    criterion)."""
    b, t, h, d = q.shape
    n_kv = k.shape[2]
    probs = _oracle_probs(q, k, _last_start(cfg, t),
                          _positions(b, t, q.device))
    return probs.amax(2).reshape(b, n_kv, h // n_kv, t).amax(2) >= tau


def critical_key_recall(q, k, v, cfg: QuokaConfig, method: str,
                        tau: float = 0.08):
    """Recall over CRITICAL keys only (``critical_keys``), a () tensor:
    diffuse bulk mass cannot reward a selector.  With no critical key it
    is 0, as in the reference."""
    b, t = q.shape[:2]
    n_kv = k.shape[2]
    sel = _last_chunk_selection(q, k, v, cfg, method)
    crit = critical_keys(q, k, cfg, tau)
    # selected slots; padding (-1) lands in a spare column that is dropped
    slots = torch.where(sel.idx >= 0, sel.idx, torch.full_like(sel.idx, t))
    sel_mask = torch.zeros((b, n_kv, t + 1), dtype=torch.bool,
                           device=q.device)
    sel_mask.scatter_(2, slots.long(), True)
    hits = (crit & sel_mask[..., :t]).sum()
    return hits / crit.sum().clamp(min=1)
