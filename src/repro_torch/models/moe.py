"""Mixture-of-Experts FFN, OLMoE / DeepSeek-V3 style (counterpart of
``repro/models/moe.py``).

Router: a softmax gate in fp32, top-k (``jax.lax.top_k``'s order: ties
at the lower expert first), renormalised; the Switch/GShard load-balance
loss ``E * sum_e f_e * p_e``.  Two dispatch paths, as in the reference:

  * ``dense``    — weighted sum over ALL experts.  Exact, used at smoke
                   scale (<= 4 experts).
  * ``capacity`` — fixed-capacity scatter/gather.  Each (token, choice) is
                   ranked within its expert by a one-hot cumsum over the
                   token-major flattening of the choices; ranks at or past
                   the capacity ``C = max(1, ceil(k * N / E * cf))`` (N: every
                   token of the batch, pad slots included) are dropped and
                   add zeros at slot C - 1; the (E, C, d) buffer goes
                   through three batched products (``torch.bmm``, as the
                   reference leaves its einsums to XLA) and is gathered
                   back, weighted.  Which pairs drop decides the output, so
                   the ranking is the reference's, bit for bit.

Plus the always-on shared experts (deepseek).  The aux loss is computed
only when the caller passes a ``ctx`` to accumulate it into (training);
inference passes none.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.quoka import topk_stable
from repro_torch.models.layers import _act, linear, mlp


class MoE(nn.Module):
    """A MoE FFN's parameters: ``router`` (d, E); the stacked expert
    weights ``gate``, ``up`` (E, d, f) and ``down`` (E, f, d), all in the
    compute dtype; ``shared`` (a gated MLP of width ``n_shared *
    d_expert``) when the config has shared experts."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        e, d, dt = cfg.moe, cfg.d_model, cfg.compute_dtype

        def w(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.router = w(d, e.n_experts)
        self.gate = w(e.n_experts, d, e.d_expert)
        self.up = w(e.n_experts, d, e.d_expert)
        self.down = w(e.n_experts, e.d_expert, d)
        self.shared = nn.ParameterDict(
            {"up": w(d, e.n_shared * e.d_expert),
             "down": w(e.n_shared * e.d_expert, d),
             "gate": w(d, e.n_shared * e.d_expert)} if e.n_shared else {})

    @torch.no_grad()
    def init(self, normal_) -> None:
        """Draw every leaf with the reference's scales through
        ``normal_(param, std)``; the expert stacks one expert at a time, so
        the fp32 draw stays one (d, f) slice however many experts there
        are."""
        d, f = self.gate.shape[1], self.gate.shape[2]
        normal_(self.router, 1.0 / math.sqrt(d))
        for i in range(self.gate.shape[0]):
            normal_(self.gate[i], 1.0 / math.sqrt(d))
            normal_(self.up[i], 1.0 / math.sqrt(d))
            normal_(self.down[i], 1.0 / math.sqrt(f))
        for p in self.shared.values():
            normal_(p, 1.0 / math.sqrt(p.shape[0]))


def route(p: MoE, x, e: MoEConfig, with_aux: bool = False):
    """x (N, d) -> (weights (N, k) in x's dtype, expert ids (N, k) int64,
    the load-balance loss or None)."""
    probs = torch.softmax(linear(p.router, x).float(), dim=-1)   # (N, E)
    w, ids = topk_stable(probs, e.top_k)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    aux = None
    if with_aux:
        f = F.one_hot(ids, e.n_experts).float().mean(dim=(0, 1)) * e.top_k
        aux = e.n_experts * torch.sum(f * probs.mean(0))
    return w.to(x.dtype), ids, aux


def capacity(e: MoEConfig, n_tokens: int) -> int:
    """Slots per expert: ``max(1, ceil(k * N / E * capacity_factor))``."""
    return max(1, int(math.ceil(e.top_k * n_tokens / e.n_experts
                                * e.capacity_factor)))


def capacity_slots(ids, n_experts: int, cap: int):
    """Each (token, choice)'s slot in its expert's buffer.  ids (N, k) ->
    (flat expert ids (N*k,), slot (N*k,), kept (N*k,) bool): the rank of the
    pair among its expert's pairs in token-major order (the k choices of
    a token in order), kept while below ``cap``; a dropped pair's slot is
    ``cap - 1``."""
    flat_e = ids.reshape(-1)
    onehot = F.one_hot(flat_e, n_experts).to(torch.int32)      # (N*k, E)
    ranks = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(ranks, 1, flat_e[:, None])[:, 0]
    keep = pos < cap
    return flat_e, torch.where(keep, pos, torch.full_like(pos, cap - 1)), keep


def _expert_ffn(p: MoE, h, act: str):
    """h (E, C, d) -> (E, C, d): every expert's SwiGLU on its own slots."""
    g = torch.bmm(h, p.gate.to(h.dtype))
    u = torch.bmm(h, p.up.to(h.dtype))
    return torch.bmm(_act(act, g) * u, p.down.to(h.dtype))


def moe_apply(p: MoE, x, cfg: ModelConfig, ctx: Optional[dict] = None):
    """x (b, t, d) -> (b, t, d).  With a ``ctx`` dict, adds
    ``router_aux_coef`` times the load-balance loss into
    ``ctx["aux_loss"]``, as the reference does."""
    e = cfg.moe
    b, t, d = x.shape
    xf = x.reshape(-1, d)                                       # (N, d)
    n = xf.shape[0]
    w, ids, aux = route(p, xf, e, with_aux=ctx is not None)
    if ctx is not None:
        ctx["aux_loss"] = ctx.get("aux_loss", 0.0) + e.router_aux_coef * aux
    if e.dispatch == "dense":
        gates = torch.zeros((n, e.n_experts), dtype=x.dtype,
                            device=x.device).scatter(1, ids, w)  # (N, E)
        h = torch.einsum("nd,edf->nef", xf, p.gate.to(x.dtype))
        u = torch.einsum("nd,edf->nef", xf, p.up.to(x.dtype))
        y = torch.einsum("nef,efd->ned", _act(cfg.act, h) * u,
                         p.down.to(x.dtype))
        out = torch.einsum("ned,ne->nd", y, gates)
    elif e.dispatch == "capacity":
        cap = capacity(e, n)
        flat_e, slot, keep = capacity_slots(ids, e.n_experts, cap)
        xe = xf.repeat_interleave(e.top_k, dim=0)               # (N*k, d)
        buf = torch.zeros((e.n_experts, cap, d), dtype=x.dtype,
                          device=x.device)
        buf.index_put_((flat_e, slot),
                       torch.where(keep[:, None], xe, torch.zeros_like(xe)),
                       accumulate=True)
        back = _expert_ffn(p, buf, cfg.act)[flat_e, slot]       # (N*k, d)
        back = torch.where(keep[:, None], back, torch.zeros_like(back))
        out = torch.sum(back.reshape(n, e.top_k, d) * w[..., None], dim=1)
    else:
        raise ValueError(e.dispatch)
    if e.n_shared:
        out = out + mlp(p.shared, xf, cfg.act)
    return out.reshape(b, t, d)
