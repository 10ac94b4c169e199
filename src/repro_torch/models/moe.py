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

Expert parallelism (``training/checkpoint.py::shard``, ``MoE.place``):
when the ``model`` axis divides the experts, rank ``r`` of ``M`` holds
experts ``[r E / M, (r + 1) E / M)`` (``ep``, ``e0``) and runs the three
products on its slice of the ``(E, C, d)`` buffer only (the ``dense``
dispatch on its experts' columns of the gates); it weights and adds the
outputs of the (token, choice) pairs routed to its experts, and that
partial and the shared experts' row-parallel partial (when their width
shards, ``tp_shared``) are summed over ``model`` in fp32 in one
all-reduce (``comm.scope("ep")``), then cast once.  Experts the axis
does not divide stay whole on every rank (``specs.param_specs`` drops the
axis), and then the routed output is NOT summed: every rank computes all
of it.  Under FSDP the caller passes the layer call's gathered weights
(``w``).  When a step's rows are split over the FSDP ranks (``rows``, the
flattened ``(pod, data)`` axis; rank-major), capacity is global, as the
reference's cumsum over the sharded token axis is: N counts every rank's
tokens, and a pair's rank within its expert adds the pairs of that expert
on the earlier ranks (an all-gather of each rank's (E,) int32 counts).
``DROPS``, when a list, receives each capacity call's dropped-pair mask
(N, k) on the host (a diagnostic: it syncs the device).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.quoka import topk_stable
from repro_torch.models.layers import (_act, linear, mlp, mlp_hidden,
                                       row_partial)
from repro_torch.sharding import comm

#: None, or a list that each capacity dispatch appends its dropped-pair
#: mask (N, k) bool to, on the host
DROPS = None


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
        self.n_experts = e.n_experts
        self.f_shared = e.n_shared * e.d_expert
        self.ep = None           # the model axis when the experts shard
        self.e0 = 0              # this rank's first expert
        self.tp_shared = None    # the model axis when ``shared`` shards

    def place(self, ax: comm.Axis) -> None:
        """Adopt the layout of the (already sliced) weights on the
        ``model`` axis ``ax``: the experts this rank holds and whether
        the shared experts' width is cut."""
        e = self.gate.shape[0]
        self.ep = ax if e < self.n_experts else None
        self.e0 = ax.rank * e if self.ep is not None else 0
        self.tp_shared = ax if self.shared and \
            self.shared["down"].shape[0] < self.f_shared else None

    def held(self):
        """The weights as this rank holds them, by their key suffix
        under ``moe/`` (the shared experts under ``shared/``)."""
        return {"router": self.router, "gate": self.gate, "up": self.up,
                "down": self.down,
                **{f"shared/{k}": p for k, p in self.shared.items()}}

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


def route(p: MoE, x, e: MoEConfig, with_aux: bool = False, router=None,
          rows=None):
    """x (N, d) -> (weights (N, k) in x's dtype, expert ids (N, k) int64,
    the load-balance loss or None); ``router``: the call's (d, E) router
    weight (default ``p``'s).  ``rows``: the axis this rank's rows are
    its share of: the loss's routed fractions and mean probabilities are
    then the whole batch's, their sums over ``rows`` (one fp32
    all-reduce of the (E,) counts and probability sums, scope ``ep``)."""
    router = p.router if router is None else router
    probs = torch.softmax(linear(router, x).float(), dim=-1)     # (N, E)
    w, ids = topk_stable(probs, e.top_k)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    aux = None
    if with_aux and (rows is None or rows.size == 1):
        f = F.one_hot(ids, e.n_experts).float().mean(dim=(0, 1)) * e.top_k
        aux = e.n_experts * torch.sum(f * probs.mean(0))
    elif with_aux:
        n = x.shape[0] * rows.size
        counts = F.one_hot(ids, e.n_experts).float().sum(dim=(0, 1))
        with comm.scope("ep"):
            sums = comm.all_reduce(torch.cat([counts, probs.sum(0)]), rows)
        f = sums[:e.n_experts] / (n * e.top_k) * e.top_k
        aux = e.n_experts * torch.sum(f * (sums[e.n_experts:] / n))
    return w.to(x.dtype), ids, aux


def capacity(e: MoEConfig, n_tokens: int) -> int:
    """Slots per expert: ``max(1, ceil(k * N / E * capacity_factor))``."""
    return max(1, int(math.ceil(e.top_k * n_tokens / e.n_experts
                                * e.capacity_factor)))


def capacity_slots(ids, n_experts: int, cap: int, rows=None):
    """Each (token, choice)'s slot in its expert's buffer.  ids (N, k) ->
    (flat expert ids (N*k,), slot (N*k,), kept (N*k,) bool): the rank of the
    pair among its expert's pairs in token-major order (the k choices of
    a token in order), kept while below ``cap``; a dropped pair's slot is
    ``cap - 1``.  ``rows``: the axis this rank's rows are its share of,
    rank-major: the pairs of the earlier ranks count first."""
    flat_e = ids.reshape(-1)
    onehot = F.one_hot(flat_e, n_experts).to(torch.int32)      # (N*k, E)
    ranks = torch.cumsum(onehot, dim=0) - onehot
    if rows is not None and rows.size > 1:
        with comm.scope("ep"):
            counts = comm.all_gather_parts(onehot.sum(0, dtype=torch.int32),
                                           rows)
        if rows.rank:
            ranks = ranks + torch.stack(counts[:rows.rank]).sum(0)
    pos = torch.gather(ranks, 1, flat_e[:, None])[:, 0]
    keep = pos < cap
    return flat_e, torch.where(keep, pos, torch.full_like(pos, cap - 1)), keep


def _expert_ffn(w, h, act: str):
    """h (E, C, d) -> (E, C, d): every expert's SwiGLU on its own slots
    (``w``: the weights of the experts ``h`` holds)."""
    g = torch.bmm(h, w["gate"].to(h.dtype))
    u = torch.bmm(h, w["up"].to(h.dtype))
    return torch.bmm(_act(act, g) * u, w["down"].to(h.dtype))


def moe_apply(p: MoE, x, cfg: ModelConfig, ctx: Optional[dict] = None,
              w: Optional[dict] = None, rows=None):
    """x (b, t, d) -> (b, t, d).  With a ``ctx`` dict, adds
    ``router_aux_coef`` times the load-balance loss into
    ``ctx["aux_loss"]``, as the reference does.  ``w``: the layer call's
    weights by ``MoE.held``'s names (default the held ones); ``rows``:
    the FSDP axis when this rank's rows are its share of the step's
    (module docstring): the capacity ranking and, in training, the
    load-balance loss count every rank's tokens."""
    e = cfg.moe
    w = p.held() if w is None else w
    b, t, d = x.shape
    xf = x.reshape(-1, d)                                       # (N, d)
    n = xf.shape[0]
    wt, ids, aux = route(p, xf, e, with_aux=ctx is not None,
                         router=w["router"], rows=rows)
    if ctx is not None:
        ctx["aux_loss"] = ctx.get("aux_loss", 0.0) + e.router_aux_coef * aux
    ep = p.ep
    n_loc = w["gate"].shape[0]                  # the experts this rank runs
    e0 = p.e0
    # the routed output, or this rank's fp32 partial of it under ``ep``
    if e.dispatch == "dense":
        gates = torch.zeros((n, e.n_experts), dtype=x.dtype,
                            device=x.device).scatter(1, ids, wt)  # (N, E)
        gates = gates[:, e0:e0 + n_loc]
        h = torch.einsum("nd,edf->nef", xf, w["gate"].to(x.dtype))
        u = torch.einsum("nd,edf->nef", xf, w["up"].to(x.dtype))
        y = torch.einsum("nef,efd->ned", _act(cfg.act, h) * u,
                         w["down"].to(x.dtype))
        if ep is None:
            out = torch.einsum("ned,ne->nd", y, gates)
        else:
            out = torch.einsum("ned,ne->nd", y.float(), gates.float())
    elif e.dispatch == "capacity":
        nr = 1 if rows is None else rows.size
        cap = capacity(e, n * nr)
        flat_e, slot, keep = capacity_slots(ids, e.n_experts, cap, rows)
        if DROPS is not None:
            DROPS.append((~keep).reshape(n, e.top_k).cpu())
        mine = keep if ep is None else \
            keep & (flat_e >= e0) & (flat_e < e0 + n_loc)
        le = (flat_e - e0).clamp(0, n_loc - 1)
        xe = xf.repeat_interleave(e.top_k, dim=0)               # (N*k, d)
        buf = torch.zeros((n_loc, cap, d), dtype=x.dtype, device=x.device)
        buf.index_put_((le, slot),
                       torch.where(mine[:, None], xe, torch.zeros_like(xe)),
                       accumulate=True)
        back = _expert_ffn(w, buf, cfg.act)[le, slot]           # (N*k, d)
        back = torch.where(mine[:, None], back, torch.zeros_like(back))
        if ep is None:
            out = torch.sum(back.reshape(n, e.top_k, d) * wt[..., None],
                            dim=1)
        else:
            out = torch.sum(back.reshape(n, e.top_k, d).float()
                            * wt.float()[..., None], dim=1)
    else:
        raise ValueError(e.dispatch)
    shared = {k[7:]: v for k, v in w.items() if k.startswith("shared/")}
    if ep is not None:
        # one fp32 sum over ``model`` of the routed and shared partials
        if e.n_shared and p.tp_shared is not None:
            out = out + row_partial(shared["down"],
                                    mlp_hidden(shared, xf, cfg.act))
        with comm.scope("ep"):
            out = comm.all_reduce(out, ep).to(x.dtype)
        if e.n_shared and p.tp_shared is None:
            out = out + mlp(shared, xf, cfg.act)
    elif e.n_shared:
        out = out + mlp(shared, xf, cfg.act, p.tp_shared)
    return out.reshape(b, t, d)
