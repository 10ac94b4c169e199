"""Primitive layers as plain functions on tensors (counterpart of
``repro/models/layers.py``).

Linear weights keep the reference layout ``(d_in, d_out)`` applied as
``x @ w``; the port stores them once in the compute dtype (the reference
casts at every use, which gives the same numbers).  The embedding and norm
gains stay fp32.

Under tensor parallelism (``sharding/comm.py``) ``ax`` names the ``model``
axis: ``embed`` looks up a vocab shard (rows ``v0 ..``) and sums the
ranks' masked rows, ``readout`` gathers the vocab shards' logits, and
``row_linear`` (a row-parallel ``wo`` or MLP ``down``) sums the ranks'
partial products in fp32 and casts once, so bf16 takes no second rounding
that the meshless product does not.

Under FSDP (``fax``, the flattened ``(pod, data)`` axis) a weight's embed
axis is cut over the FSDP ranks too: ``gather_weights`` rebuilds a
layer's weights for one call; the embedding table, whose rows a step
reads by token, is never gathered whole: ``embed`` gathers the rows the
FSDP ranks' tokens read (each rank looks them up in its columns), and
``readout`` sums each rank's columns' partial logits of every FSDP
rank's rows, so it returns the logits of every FSDP rank's rows, in
rank order.

In training every collective here carries its backward
(``sharding/comm.py``): the row-parallel and vocab-parallel sums
all-reduce their gradients, ``gather_weights`` reduce-scatters the
whole weights' gradients into the FSDP shards, and the embedding's and
read-out's gathers return each rank its rows' and columns' share.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import comm


def linear(w, x, b=None):
    """``x @ w`` in x's dtype."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def row_linear(w, x, ax=None):
    """``linear(w, x)`` for a row-parallel ``w`` (this rank's rows of the
    input dimension): the partial products in fp32 (``row_partial``),
    summed over ``ax``, cast to x's dtype once.  Meshless (``ax`` None) it
    is ``linear``."""
    if ax is None:
        return linear(w, x)
    return comm.all_reduce(row_partial(w, x), ax).to(x.dtype)


class _MmFp32Out(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=torch.float32)`` (which has no
    derivative) with a backward: the two GEMMs in x's dtype, as
    ``linear``'s backward runs them."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return (g @ w.t() if ctx.needs_input_grad[0] else None,
                x.t() @ g if ctx.needs_input_grad[1] else None)


def row_partial(w, x):
    """This rank's fp32 partial product ``x @ w`` of a row-parallel
    ``w``, before the sum over the ranks.  On the card a bf16 product
    stays a bf16 GEMM and only its result is fp32; the CPU has no such
    GEMM and upcasts."""
    if x.is_cuda and x.dtype != torch.float32:
        # one half-precision GEMM with an fp32 result (fp32 accumulation)
        return _MmFp32Out.apply(x.reshape(-1, x.shape[-1]), w).reshape(
            *x.shape[:-1], -1)
    return x.float() @ w.float()


def gather_weights(ws, fax):
    """Whole weights from this rank's FSDP shards, for one call: ``ws``
    maps a name to (shard, the dimension the FSDP axis ``fax`` cut); the
    shards (one dtype) travel in one flat all-gather, under
    ``comm.scope("fsdp")``."""
    names = list(ws)
    flat = torch.cat([ws[n][0].reshape(-1) for n in names])
    with comm.scope("fsdp"):
        parts = comm.all_gather_parts(flat, fax)
    out, off = {}, 0
    for n in names:
        w, dim = ws[n]
        k = w.numel()
        out[n] = torch.cat([p[off:off + k].view(w.shape) for p in parts],
                           dim=dim)
        off += k
    return out


def embed(emb, tokens, dtype, ax=None, v0: int = 0, fax=None):
    """Rows of ``emb`` for ``tokens``, cast to ``dtype``.  With ``ax``,
    ``emb`` is the vocab shard starting at row ``v0``: tokens outside it
    read zeros, and the ranks' rows are summed (exact: one is nonzero).
    With ``fax``, ``emb`` holds this rank's columns of the embed axis:
    every FSDP rank's tokens are looked up in them and the columns
    gathered back, then this rank's rows kept (the module docstring)."""
    b = tokens.shape[0]
    if fax is not None:
        with comm.scope("fsdp"):
            tokens = comm.all_gather(tokens, fax, dim=0)
    if ax is None:
        rows = emb[tokens]
    else:
        loc = tokens.long() - v0
        ok = (loc >= 0) & (loc < emb.shape[0])
        rows = emb[loc.clamp(0, emb.shape[0] - 1)]
        rows = torch.where(ok[..., None], rows, torch.zeros_like(rows))
    if fax is not None:
        with comm.scope("fsdp"):
            rows = comm.all_gather(rows, fax, dim=-1)
        rows = rows[fax.rank * b:(fax.rank + 1) * b]
    return (rows if ax is None else comm.all_reduce(rows, ax)).to(dtype)


def readout(w, x, fax=None, ax=None, tied: bool = True):
    """The fp32 read-out ``x @ w^T`` of the tied embedding (vocab [shard],
    d [/ D]) or ``x @ w`` of an untied ``lm_head`` (d [/ D], vocab
    [shard]).  Under FSDP (``fax``) ``x`` is this rank's rows: every FSDP
    rank's rows are gathered, and where ``fax`` cut the embed axis of
    ``w``, each rank multiplies its columns of them by its slice and the
    partial logits are summed over ``fax``.  With ``ax``, the vocab
    shards' logits are gathered in rank order."""
    xf = x.float()
    wf = w.float().T if tied else w.float()
    n = wf.shape[0]
    with comm.scope("fsdp"):
        if fax is not None:
            xf = comm.all_gather(xf, fax, dim=0)
        if n < xf.shape[-1]:
            xf = xf[..., fax.rank * n:(fax.rank + 1) * n]
            logits = comm.all_reduce(xf @ wf, fax)
        else:
            logits = xf @ wf
    return logits if ax is None else comm.all_gather(logits, ax, dim=-1)


def rmsnorm(g, x, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * g).to(dt)


def layernorm(g, b, x, eps: float = 1e-5):
    """LayerNorm with fp32 statistics, an affine gain ``g`` and bias ``b``,
    cast back to x's dtype (whisper's block norms)."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g + b).to(dt)


def groupnorm(x, n_groups: int, eps: float = 1e-5):
    """Per-head group norm (RWKV6's, no learned affine); fp32 statistics."""
    dt = x.dtype
    shp = x.shape
    xf = x.float().reshape(*shp[:-1], n_groups, shp[-1] // n_groups)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).reshape(shp).to(dt)


def _act(name: str, x):
    if name == "silu":
        return F.silu(x)
    if name == "gelu":       # the tanh form, as ``jax.nn.gelu``'s default
        return F.gelu(x, approximate="tanh")
    if name == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def mlp(p, x, act: str = "silu", ax=None):
    """Gated MLP; ``p`` maps "up", "down" and optionally "gate" to weights.
    With ``ax`` the hidden dimension is sharded: "up" / "gate" column-
    parallel, "down" row-parallel (``row_linear``)."""
    return row_linear(p["down"], mlp_hidden(p, x, act), ax)


def mlp_hidden(p, x, act: str = "silu"):
    """The gated MLP's hidden activation, the input of ``down``."""
    up = linear(p["up"], x)
    if "gate" in p:
        return _act(act, linear(p["gate"], x)) * up
    return _act(act, up)


def rope(x, positions, theta: float):
    """Split-half rotary embedding.  x: (b, T, n_heads, hd); positions
    (b, T)."""
    dt = x.dtype
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs                  # (b, T, half)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().split(half, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(dt)


def sinusoidal(positions, d: int, dtype=torch.float32):
    """Whisper-style sinusoidal position embedding (models without rope).
    positions: (..., T) -> (..., T, d)."""
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def l2_normalize(x, dim: int = -1, eps: float = 1e-8):
    xf = x.float()
    return (xf / (xf.norm(dim=dim, keepdim=True) + eps)).to(x.dtype)
