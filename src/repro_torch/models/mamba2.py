"""Mamba2 (SSD) mixer for the zamba2 hybrid (counterpart of
``repro/models/mamba2.py``; arXiv:2411.15242 backbone).

The segment is scanned in sub-chunks of ``CHUNK`` tokens: inside a
sub-chunk the pairwise (b, t, s, H) decay tensor gives the intra-chunk
term, and the fp32 state carried across sub-chunks (a Python loop here,
the reference's ``lax.scan``) gives the rest.  Every sub-chunk's terms
are computed in one batch and the loop carries the state alone: eager
PyTorch pays a host dispatch per operation, at every layer call.  The
decay is a scalar per head per step, and every exponent is a difference
of cumulative log-decays (<= 0), masked to ``-inf`` above the diagonal
before ``exp``.

The projections stay separate (``z`` / ``x`` / ``bc`` / ``dt``) and the
depthwise convolution is split into its ``x`` and ``[B | C]`` channels, as
in the reference, so its checkpoint maps leaf for leaf.  Linear and
convolution weights are stored once in the compute dtype (the reference
casts them at every use: the same numbers); ``a_log``, ``d_skip``,
``dt_bias`` and the norm gain stay fp32.

State per layer (``serving/cache.py::MambaCache``): the convolution's last
``d_conv - 1`` inputs and the SSD state (b, H, P, N) in fp32.

Tensor parallelism (``Mamba2.place``, after ``training/checkpoint.py::
shard`` sliced the leaves by the reference's rules): a rank holds the
columns of ``z_proj`` / ``x_proj`` / ``dt_proj`` and the channels of
``conv_x_*``, ``a_log``, ``d_skip``, ``dt_bias`` and ``norm`` of its own
SSD heads, contiguous and head-major, while ``bc_proj`` and
``conv_bc_*`` (the B and C shared by every head) stay whole; the scan
runs on its heads alone, and ``out_proj`` is row-parallel (one fp32
all-reduce over ``model``, ``layers.row_linear``).  The gated RMSNorm
normalises over the whole ``d_inner``: its fp32 sum of squares, one (b,
T) vector, is summed over ``model`` before the scale (``_gated_norm``).
The convolution tail keeps the rank's x channels and the whole B / C
channels (``[x_local | B | C]``), where the reference's ``cache_specs``
cuts the concatenated channel axis at its midpoint, off the heads
(``ROADMAP.md`` C, deliberate differences).  Under FSDP the caller passes
the layer call's gathered weights (``w``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import linear, rmsnorm, row_linear
from repro_torch.serving.cache import MambaCache
from repro_torch.sharding import comm

CHUNK = 64

# leaves applied as ``x @ w`` (the reference's ``{"w": ...}`` dicts)
LINEARS = ("z_proj", "x_proj", "bc_proj", "dt_proj", "out_proj")


def _dims(cfg: ModelConfig):
    """(d_inner, SSD heads, convolution channels: x, B and C)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return di, di // s.head_dim, di + 2 * s.d_state


class Mamba2(nn.Module):
    """One mixer's parameters under the reference's leaf names."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        s, d = cfg.ssm, cfg.d_model
        di, nh, _ = _dims(cfg)

        def w(*shape, dtype=cfg.compute_dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)
        self.z_proj = w(d, di)
        self.x_proj = w(d, di)
        self.bc_proj = w(d, 2 * s.d_state)
        self.dt_proj = w(d, nh)
        self.conv_x_w = w(s.d_conv, di)
        self.conv_x_b = w(di)
        self.conv_bc_w = w(s.d_conv, 2 * s.d_state)
        self.conv_bc_b = w(2 * s.d_state)
        self.a_log = w(nh, dtype=torch.float32)
        self.d_skip = w(nh, dtype=torch.float32)
        self.dt_bias = w(nh, dtype=torch.float32)
        self.norm = w(di, dtype=torch.float32)
        self.out_proj = w(di, d)
        self.d_inner, self.n_heads = di, nh     # the whole layer's
        self.tp = None      # the model axis when this rank holds its heads

    def place(self, ax: comm.Axis) -> None:
        """Adopt the layout of the (already sliced) weights on the
        ``model`` axis ``ax``: this rank's SSD heads, or all of them."""
        di, nh = self.norm.shape[0], self.a_log.shape[0]
        widths = {t.shape[-1] for t in (self.z_proj, self.x_proj,
                                        self.conv_x_w, self.conv_x_b)}
        heads = {t.shape[-1] for t in (self.dt_proj, self.d_skip,
                                       self.dt_bias)}
        if widths | {self.out_proj.shape[0]} != {di} or heads != {nh} or \
                di * self.n_heads != nh * self.d_inner:
            raise NotImplementedError(
                "a Mamba2 placement that cuts its heads and channels "
                "differently is not yet ported")
        self.tp = ax if di < self.d_inner else None

    def held(self):
        """Every leaf as this rank holds it, by its name."""
        return dict(self.named_parameters())

    @torch.no_grad()
    def init(self, normal_, uniform_) -> None:
        """The reference's initialisers: linear weights 1/sqrt(d_in), the
        convolutions 1/sqrt(d_conv) with zero bias, ``a_log`` = log of
        1..16, ``d_skip`` ones, ``dt_bias`` the inverse softplus of a
        log-uniform step in [1e-3, 1e-1]."""
        for name in LINEARS:
            p = getattr(self, name)
            normal_(p, 1.0 / math.sqrt(p.shape[0]))
        for wt, bias in ((self.conv_x_w, self.conv_x_b),
                         (self.conv_bc_w, self.conv_bc_b)):
            normal_(wt, 1.0 / math.sqrt(wt.shape[0]))
            bias.zero_()
        nh = self.a_log.shape[0]
        self.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh)))
        self.d_skip.fill_(1.0)
        uniform_(self.dt_bias, math.log(1e-3), math.log(1e-1))
        self.dt_bias.copy_(torch.log(torch.expm1(torch.exp(self.dt_bias))))
        self.norm.fill_(1.0)


def _causal_conv(xc, tail, w, b):
    """Depthwise causal convolution over time in xc's dtype.  xc (b, T,
    ch), tail (b, K - 1, ch): the previous segment's last inputs.  The K
    shifted products summed in the reference's order, the bias after.
    Returns (y (b, T, ch), new tail)."""
    kw, t = w.shape[0], xc.shape[1]
    full = torch.cat([tail.to(xc.dtype), xc], dim=1)
    wd = w.to(xc.dtype)
    y = full[:, :t] * wd[0]
    for i in range(1, kw):
        y = y + full[:, i:i + t] * wd[i]
    y = y + b.to(xc.dtype)
    return y, (full[:, -(kw - 1):] if kw > 1 else tail)


def _ssd_chunked(x, dt, la, B, C, state):
    """Chunked SSD scan.  x (b, T, H, P) fp32; dt, la (b, T, H), la the
    log-decay <= 0; B, C (b, T, N); state (b, H, P, N) fp32.  T is a
    multiple of the sub-chunk (the caller pads).  Returns (y (b, T, H, P),
    new state).

    The reference's per-sub-chunk terms, computed for every sub-chunk at
    once; only the state carried from one sub-chunk to the next is a
    Python loop (one multiply-add per sub-chunk)."""
    b, t, h, p = x.shape
    c = min(CHUNK, t)
    n = t // c
    xs, dts, las, Bs, Cs = (a.reshape(b, n, c, *a.shape[2:])
                            for a in (x, dt, la, B, C))
    cum = las.cumsum(2)                                       # (b, n, c, H)
    # intra: P[t, s] = (C_t . B_s) exp(cum_t - cum_s) dt_s, s <= t
    above = ~torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    expo = (cum[:, :, :, None] - cum[:, :, None]).masked_fill(
        above[:, :, None], float("-inf"))                     # (b,n,t,s,H)
    cb = Cs @ Bs.transpose(-1, -2)                            # (b, n, t, s)
    pm = cb[..., None] * torch.exp(expo) * dts[:, :, None]
    y = torch.einsum("bntsh,bnshp->bnthp", pm, xs)
    # each sub-chunk's own contribution to the state at its end
    coef = torch.exp(cum[:, :, -1:] - cum) * dts              # (b, n, c, H)
    add = torch.einsum("bnchp,bncm->bnhpm", coef[..., None] * xs, Bs)
    decay = torch.exp(cum[:, :, -1])[..., None, None]         # (b,n,H,1,1)
    entering = []
    for dk, ak in zip(decay.unbind(1), add.unbind(1)):
        entering.append(state)
        state = dk * state + ak
    # inter: y_t += (exp(cum_t) S) . C_t, S the state entering the chunk
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "bnhpm,bntm->bnthp", torch.stack(entering, 1), Cs)
    return y.reshape(b, t, h, p), state


def _gated_norm(g, y, z, ax, d_inner: int, eps: float = 1e-6):
    """``rmsnorm(g, y * silu(z))`` over the whole ``d_inner``: with the
    ``model`` axis ``ax`` this rank holds ``g``'s channels of it, and the
    fp32 sum of squares of every rank's channels is summed over ``ax``
    first (a (b, T) vector)."""
    h = y * F.silu(z)
    if ax is None:
        return rmsnorm(g, h, eps)
    hf = h.float()
    ss = comm.all_reduce((hf * hf).sum(-1, keepdim=True), ax)
    return (hf * torch.rsqrt(ss / d_inner + eps) * g).to(h.dtype)


def mamba_apply(p: Mamba2, x, cache: MambaCache, cfg: ModelConfig, w=None):
    """One Mamba2 mixer over the segment x (b, T, d) (already normed), on
    this rank's heads (``p.tp``; all of them meshless) with the layer
    call's weights ``w`` (default: ``p``'s own, ``Mamba2.held``).
    Returns (y (b, T, d), the new ``MambaCache``); ``cache`` is read, not
    written."""
    s = cfg.ssm
    w = p.held() if w is None else w
    b, t, _ = x.shape
    di, nh = w["norm"].shape[0], w["a_log"].shape[0]
    z = linear(w["z_proj"], x)
    # the split convolution is depthwise, so its x and [B | C] channels
    # run as one pass over [x | B | C], the cache's channel order
    xbc, tail = _causal_conv(
        torch.cat([linear(w["x_proj"], x), linear(w["bc_proj"], x)], dim=-1),
        cache.conv, torch.cat([w["conv_x_w"], w["conv_bc_w"]], dim=-1),
        torch.cat([w["conv_x_b"], w["conv_bc_b"]]))
    xbc = F.silu(xbc).float()
    x_ssm = xbc[..., :di].reshape(b, t, nh, s.head_dim)
    Bm = xbc[..., di:di + s.d_state]
    Cm = xbc[..., di + s.d_state:]
    dt = F.softplus(linear(w["dt_proj"], x).float() + w["dt_bias"])
    la = -dt * torch.exp(w["a_log"])                            # <= 0
    # pad to the sub-chunk: la = 0 keeps the state, dt = 0 adds nothing
    pad = (-t) % min(CHUNK, max(t, 1))
    xs, Bs, Cs, dts, las = x_ssm, Bm, Cm, dt, la
    if pad:
        def pf(a):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        xs, Bs, Cs, dts, las = (pf(a) for a in (x_ssm, Bm, Cm, dt, la))
    y, state = _ssd_chunked(xs, dts, las, Bs, Cs, cache.ssd)
    y = y[:, :t] + w["d_skip"][None, None, :, None] * x_ssm
    y = y.reshape(b, t, di).to(x.dtype)
    y = _gated_norm(w["norm"], y, z, p.tp, p.d_inner)
    return row_linear(w["out_proj"], y, p.tp), MambaCache(conv=tail,
                                                          ssd=state)
