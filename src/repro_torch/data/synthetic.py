"""Synthetic data (counterpart of ``repro/data/synthetic.py``): (a) an LM
stream with induction structure, (b) the needle-in-a-haystack retrieval
task and its accuracy through chunked prefill, and (c) structured Q/K/V
with the paper's Figure-2 geometry.

Token map for (a) and (b): 0 PAD, 1 NEEDLE, 2 QUERY, [3, 3 + n_keys) key
ids, [3 + n_keys, 3 + 2 n_keys) value ids, the rest filler.

(a) and (b) draw with numpy exactly as the reference does.  The reference
seeds its numpy generator with an integer it draws from a ``jax.random``
key; these functions take that integer (``seed``), so the same integer
gives the reference's token stream.  ``REF_SEED`` is the integer the
reference draws from ``PRNGKey(0)``, its launchers' and tests' key.
(c) is drawn from an explicit ``torch.Generator`` on the caller's device,
so a T = 8192 input is made on the card in one go; its numbers are not
``jax.random``'s, only the geometry is the same.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

PAD, NEEDLE, QUERY = 0, 1, 2

# int(jax.random.randint(jax.random.PRNGKey(0), (), 0, 2**31 - 1))
REF_SEED = 31327077


def lm_batches(seed: int, vocab: int, batch: int, seq: int,
               repeat_frac: float = 0.3) -> Iterator[Dict]:
    """Infinite stream of ``{"tokens": (batch, seq) int32}``: random tokens
    where, with probability ``repeat_frac`` per row, a span of the first
    half repeats in the second (a learnable induction signal)."""
    rng = np.random.default_rng(seed)
    while True:
        toks = rng.integers(3, vocab, size=(batch, seq))
        half = seq // 2
        for b in range(batch):
            if rng.random() < repeat_frac and half > 8:
                span = rng.integers(4, min(64, half))
                src = rng.integers(0, half - span)
                dst = rng.integers(half, seq - span)
                toks[b, dst:dst + span] = toks[b, src:src + span]
        yield {"tokens": toks.astype(np.int32)}


def needle_batch(rng: np.random.Generator, vocab: int, batch: int, seq: int,
                 n_keys: int = 32, depth: float | None = None,
                 n_distractors: int = 0) -> Dict:
    """Rows ``[filler ... NEEDLE k v ... QUERY k v]``: the model must emit v
    after (QUERY, k).  ``n_distractors`` more (NEEDLE k' v') pairs with
    other keys are inserted (RULER multi-key style); ``depth`` pins the
    true needle's place.  ``loss_mask`` marks the answer position only."""
    if vocab < 3 + 2 * n_keys + 8:
        raise ValueError(f"vocab {vocab} too small for {n_keys} keys")
    if n_distractors + 1 > n_keys:
        raise ValueError("more distractors than keys")
    filler_lo = 3 + 2 * n_keys
    toks = rng.integers(filler_lo, vocab, size=(batch, seq))
    mask = np.zeros((batch, seq), np.float32)
    for b in range(batch):
        kids = rng.permutation(n_keys)[: n_distractors + 1]
        lo, hi = 1, seq - 6
        spots = rng.permutation(np.arange(lo, hi - 3, 4))[: n_distractors + 1]
        if depth is not None:          # the true needle is spot 0
            spots[0] = int(lo + (hi - lo) * depth)
        for kid, pos in zip(kids, spots):
            k_tok, v_tok = 3 + int(kid), 3 + n_keys + int(kid)
            toks[b, pos:pos + 3] = [NEEDLE, k_tok, v_tok]
        k0, v0 = 3 + int(kids[0]), 3 + n_keys + int(kids[0])
        toks[b, -3:] = [QUERY, k0, v0]
        mask[b, -1] = 1.0              # predict v at the last position
    return {"tokens": toks.astype(np.int32), "loss_mask": mask}


def needle_batches(seed: int, vocab: int, batch: int, seq: int,
                   n_keys: int = 32, n_distractors: int = 0
                   ) -> Iterator[Dict]:
    rng = np.random.default_rng(seed)
    while True:
        yield needle_batch(rng, vocab, batch, seq, n_keys,
                           n_distractors=n_distractors)


def needle_accuracy(model, batch: Dict, method: str,
                    chunk_pad: int = 128) -> float:
    """Retrieval accuracy: chunked prefill (``Model.prefill``, so the
    selection and attention kernels on the card) over ``tokens[:-1]``, cut
    at the front to a multiple of the chunk, with ``method``; the share of
    rows whose argmax is the needle's value."""
    tok = np.asarray(batch["tokens"])
    b, t = tok.shape
    tp = (t - 1) - ((t - 1) % min(chunk_pad, model.cfg.quoka.chunk_size))
    prompt = tok[:, (t - 1) - tp: t - 1]
    target = torch.as_tensor(tok[:, -1], device=model.device)
    logits, _ = model.prefill({"tokens": prompt},
                              model.init_cache(b, tp + 8), method)
    return float((logits.argmax(-1) == target).float().mean())


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
