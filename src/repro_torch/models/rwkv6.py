"""RWKV6 "Finch" block (counterpart of ``repro/models/rwkv6.py``;
arXiv:2404.05892): attention-free time-mix with a data-dependent decay,
then the squared-ReLU channel-mix.

The time-mix recurrence runs in sub-chunks of ``CHUNK`` tokens: the
intra-chunk interactions are a masked (b, h, t, s, d) exponent tensor per
sub-chunk, the ``u`` bonus sits on the diagonal, and the fp32 wkv state is
carried across sub-chunks by a Python loop (the reference's
``lax.scan``).  Every sub-chunk's terms are computed in one batch and the
loop carries the state alone: eager PyTorch pays a host dispatch per
operation, at every layer call.  Every exponent is a difference of
cumulative log-decays (<= 0), so the fp32 math never overflows.

Dtypes.  The decay (``w0 + tanh(xw @ wa) @ wb``) and the recurrence are
fp32 as in the reference, and the leaves it keeps in fp32 (``mu``, ``w0``,
``wa``, ``wb``, ``u``) stay fp32 here.  The token-shift mix runs in the
input's dtype, so a bf16 model keeps a bf16 residual stream; the
reference's fp32 ``mu`` promotes its stream to fp32, which its scan over
layers refuses at bf16 (it runs fp32 only).  At fp32 the two are the same
computation.

State per layer (``serving/cache.py::RWKVCache``): the last normed token
entering each mix and the wkv state (b, H, D, D) in fp32.  QUOKA has
nothing to select here: there is no KV cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import groupnorm, linear

CHUNK = 16  # intra-chunk width (a C * C * D working set per head)

# leaves applied as ``x @ w`` (the reference's ``{"w": ...}`` dicts)
TM_LINEARS = ("wr", "wk", "wv", "wg", "wo")
CM_LINEARS = ("wk", "wv", "wr")


def _weight(dtype, device):
    def w(*shape):
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                            requires_grad=False)
    return w


class TimeMix(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.rwkv.head_dim
        w = _weight(cfg.compute_dtype, device)
        f32 = _weight(torch.float32, device)
        self.mu = f32(5, d)                       # r, k, v, g, w shift mix
        for name in TM_LINEARS:
            setattr(self, name, w(d, d))
        self.w0 = f32(d)                          # decay bias
        self.wa = f32(d, cfg.rwkv.decay_lora)
        self.wb = f32(cfg.rwkv.decay_lora, d)
        self.u = f32(d // hd, hd)                 # bonus

    @torch.no_grad()
    def init(self, normal_, cfg: ModelConfig) -> None:
        d = cfg.d_model
        self.mu.fill_(0.5)
        for name in ("wr", "wk", "wv", "wg"):
            normal_(getattr(self, name), 1.0 / math.sqrt(d))
        normal_(self.wo, 1.0 / math.sqrt(d) / math.sqrt(2 * cfg.n_layers))
        # decays spread across channels, as the reference's RWKV-style init
        ramp = torch.arange(d, dtype=torch.float32) / max(d - 1, 1)
        self.w0.copy_(-5.0 + 8.0 * ramp ** 0.7)
        normal_(self.wa, 0.01)
        normal_(self.wb, 0.01)
        normal_(self.u, 0.1)


class ChannelMix(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        w = _weight(cfg.compute_dtype, device)
        self.mu = _weight(torch.float32, device)(2, d)   # k, r shift mix
        self.wk = w(d, cfg.d_ff)
        self.wv = w(cfg.d_ff, d)
        self.wr = w(d, d)

    @torch.no_grad()
    def init(self, normal_, cfg: ModelConfig) -> None:
        self.mu.fill_(0.5)
        for name in CM_LINEARS:
            p = getattr(self, name)
            normal_(p, 1.0 / math.sqrt(p.shape[0]))


def _shift_mix(x, x_prev, mu):
    """Token shift: each token interpolated with its predecessor, once per
    row of mu.  x (b, T, d), x_prev (b, d) the carry; mu (k, d), applied in
    x's dtype.  Returns (k, b, T, d)."""
    shifted = torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    return x + (shifted - x) * mu.to(x.dtype)[:, None, None]


def _time_mix_chunked(r, k, v, lw, u, state):
    """Chunked linear-attention recurrence.  r, k, v, lw (b, T, H, D) fp32,
    lw the log-decay <= 0; u (H, D); state (b, H, D, D).  T is a multiple
    of the sub-chunk (the caller pads).  Returns (out (b, T, H, D), new
    state).

    The reference's per-sub-chunk terms, computed for every sub-chunk at
    once; only the state carried from one sub-chunk to the next is a
    Python loop (one multiply-add per sub-chunk)."""
    b, t, h, d = r.shape
    c = min(CHUNK, t)
    n = t // c
    rc, kc, vc, wc = (a.reshape(b, n, c, h, d).transpose(2, 3)
                      for a in (r, k, v, lw))              # (b, n, h, c, d)
    cum = wc.cumsum(3)                                        # inclusive
    ecum = cum - wc                                           # exclusive
    # intra-chunk pairwise (t, s, d) exponents, <= 0 for s < t
    upper = ~torch.ones((c, c), dtype=torch.bool,
                        device=r.device).tril(-1)             # s >= t
    expo = (ecum[..., :, None, :] - cum[..., None, :, :]).masked_fill(
        upper[:, :, None], float("-inf"))
    pmat = (rc[..., :, None, :] * kc[..., None, :, :]
            * torch.exp(expo)).sum(-1)                        # (b,n,h,t,s)
    # the u bonus on the diagonal
    diag = (rc * kc * u.float()[:, None]).sum(-1)             # (b,n,h,c)
    pmat = pmat + torch.diag_embed(diag)
    out = pmat @ vc
    # each sub-chunk's own contribution to the state at its end
    kd = kc * torch.exp(cum[..., -1:, :] - cum)
    add = kd.transpose(-1, -2) @ vc                           # (b,n,h,d,d)
    decay = torch.exp(cum[..., -1, :])[..., None]             # (b,n,h,d,1)
    entering = []
    for dk, ak in zip(decay.unbind(1), add.unbind(1)):
        entering.append(state)
        state = dk * state + ak
    out = out + (rc * torch.exp(ecum)) @ torch.stack(entering, 1)
    return out.transpose(2, 3).reshape(b, t, h, d), state


def time_mix(p: TimeMix, x, shift_prev, wkv_state, cfg: ModelConfig):
    """x (b, T, d) already normed.  Returns (y (b, T, d), the new shift
    (the normed input's last token), the new wkv state)."""
    b, t, d = x.shape
    hd = cfg.rwkv.head_dim
    nh = d // hd
    xr, xk, xv, xg, xw = _shift_mix(x, shift_prev, p.mu)
    r = linear(p.wr, xr).float()
    k = linear(p.wk, xk).float()
    v = linear(p.wv, xv).float()
    g = linear(p.wg, xg)
    # the data-dependent decay (Finch's headline feature), fp32
    ww = p.w0 + torch.tanh(xw.float() @ p.wa) @ p.wb
    lw = -torch.exp(ww)                                       # <= 0
    pad = (-t) % min(CHUNK, max(t, 1))
    if pad:    # zeros: lw = 0 is decay 1, k = v = 0 adds nothing
        r, k, v, lw = (F.pad(a, (0, 0, 0, pad)) for a in (r, k, v, lw))
    out, state = _time_mix_chunked(
        *(a.reshape(b, -1, nh, hd) for a in (r, k, v, lw)), p.u,
        wkv_state.float())
    out = out[:, :t].reshape(b, t, d)
    y = groupnorm(out, nh).to(x.dtype) * F.silu(g)
    return linear(p.wo, y), x[:, -1], state


def channel_mix(p: ChannelMix, x, shift_prev):
    """x (b, T, d) already normed.  Returns (y, the new shift)."""
    xk, xr = _shift_mix(x, shift_prev, p.mu)
    k = F.relu(linear(p.wk, xk))
    return torch.sigmoid(linear(p.wr, xr)) * linear(p.wv, k * k), x[:, -1]
