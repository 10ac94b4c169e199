"""Token sampling: greedy / temperature / top-k / top-p (counterpart of
``repro/serving/sampler.py``).  Random draws come from an explicit
``torch.Generator``; they cannot reproduce ``jax.random``'s bits, so only
greedy output is compared token for token with the reference."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0        # 0 = greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None


def filter_logits(logits, cfg: SamplerConfig):
    """Temperature-scaled logits with the top-k / top-p cut applied (-inf
    outside the kept set)."""
    lg = logits.float() / cfg.temperature
    neg = torch.full_like(lg, float("-inf"))
    if cfg.top_k is not None:
        kth = torch.topk(lg, cfg.top_k, dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, neg, lg)
    if cfg.top_p is not None:
        srt = torch.sort(lg, dim=-1, descending=True).values
        csum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
        # the token whose cumulative mass crosses p is kept; clamp the
        # index (rounding can leave csum[-1] < p) and always keep the
        # max-prob token (csum[0] >= p gives an empty nucleus)
        cutoff = torch.clamp((csum < cfg.top_p).sum(-1, keepdim=True),
                             max=lg.shape[-1] - 1)
        kth = torch.gather(srt, -1, cutoff)
        keep = (lg >= kth) | (lg >= lg.amax(-1, keepdim=True))
        lg = torch.where(keep, lg, neg)
    return lg


def sample(logits, generator: Optional[torch.Generator],
           cfg: SamplerConfig):
    """logits: (b, V) -> (b,) int64 token ids."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
