"""Structured Q/K/V with the paper's Figure-2 geometry (counterpart of
``repro/data/synthetic.py::structured_qkv``; the LM stream and the NIAH
task wait for the training slice).

The arrays are drawn from an explicit ``torch.Generator`` on the caller's
device, so a T = 8192 input is made on the card in one go; the numbers are
not ``jax.random``'s, only the geometry is the same.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def structured_qkv(seed: int, b: int, t: int, h: int, n_kv: int, d: int,
                   outlier_frac: float = 0.08, n_needles: int = 24,
                   n_sinks: int = 4, sharp: float = 8.0, device="cpu"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 q (b, t, h, d), k and v (b, t, n_kv, d) mirroring Figure 2:

      * bulk queries cluster around the mean query direction and put their
        attention on a few shared SINK keys (the first ``n_sinks``
        positions, aligned with the bulk queries and large);
      * about ``outlier_frac`` of the tokens are OUTLIER queries (low
        cosine with the mean query) aimed, at the bulk queries' norm, at
        one of ``n_needles`` NEEDLE keys at fixed scattered positions;
      * the key cluster has negative cosine with the mean query;
      * needle values are large, so missing a needle costs O(1) output
        error.

    Mean or uniform query aggregation washes the outliers out; QUOKA's
    dissimilar-query subselection keeps them."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    dk = normal(d)
    dk = dk / dk.norm()
    dq = -dk                                  # bulk query direction
    k_noise = normal(b, t, n_kv, d) * 0.5
    k = dk * 1.5 + k_noise
    ar = torch.arange(t, device=dev)
    sink = (ar < n_sinks)[None, :, None, None]
    k = torch.where(sink, dq * 16.0 + k_noise * 0.2, k)
    needle_pos = torch.as_tensor(
        np.linspace(n_sinks + 3, t - 8, n_needles).astype(np.int32),
        device=dev).long()
    needle_dirs = normal(n_needles, d)
    needle_dirs = needle_dirs / needle_dirs.norm(dim=-1, keepdim=True)
    is_needle = torch.zeros(t, dtype=torch.bool, device=dev)
    is_needle[needle_pos] = True
    ndir_full = torch.zeros((t, d), device=dev)
    ndir_full[needle_pos] = needle_dirs * 4.0
    needle = is_needle[None, :, None, None]
    k = torch.where(needle, ndir_full[None, :, None, :] + k_noise * 0.2, k)
    v = normal(b, t, n_kv, d)
    v = torch.where(needle, v * 3.0, v)
    q_noise = normal(b, t, h, d) * 0.3
    q = dq * 2.5 + q_noise
    # outlier-ness and the target needle are per token, shared by the heads
    is_out = torch.rand((b, t, 1, 1), generator=gen, device=dev) \
        < outlier_frac
    tgt = needle_pos[torch.randint(0, n_needles, (b, t), generator=gen,
                                   device=dev)]
    kq = torch.gather(k.mean(2), 1, tgt[..., None].expand(-1, -1, d))
    kq_dir = (kq / (kq.norm(dim=-1, keepdim=True) + 1e-8))[:, :, None, :]
    bulk_norm = q.norm(dim=-1, keepdim=True)
    q = torch.where(is_out, kq_dir * bulk_norm * (sharp / 3.0) + q_noise, q)
    return q, k, v
