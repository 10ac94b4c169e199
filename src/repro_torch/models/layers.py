"""Primitive layers as plain functions on tensors (counterpart of
``repro/models/layers.py``).

Linear weights keep the reference layout ``(d_in, d_out)`` applied as
``x @ w``; the port stores them once in the compute dtype (the reference
casts at every use, which gives the same numbers).  The embedding and norm
gains stay fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def linear(w, x, b=None):
    """``x @ w`` in x's dtype."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def embed(emb, tokens, dtype):
    return emb[tokens].to(dtype)


def unembed(emb, x):
    """Tied read-out in fp32: logits = x @ emb^T."""
    return x.float() @ emb.float().T


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


def mlp(p, x, act: str = "silu"):
    """Gated MLP; ``p`` maps "up", "down" and optionally "gate" to weights."""
    up = linear(p["up"], x)
    if "gate" in p:
        h = _act(act, linear(p["gate"], x)) * up
    else:
        h = _act(act, up)
    return linear(p["down"], h)


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
