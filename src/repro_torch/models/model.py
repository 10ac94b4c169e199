"""Dense decoder model: embedding, layer stacks, tied read-out (counterpart
of ``repro/models/model.py``, dense family only).

Entry points: ``prefill`` (chunked prefill, paper Algorithm 2: a Python
loop over chunks, each selecting from the KV cache per layer) and
``decode_step``.  Training forward, modality frontends, the MTP head and
per-chunk continuous-batching dispatch are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import embed, rmsnorm, unembed
from repro_torch.models.stack import Stack
from repro_torch.serving.cache import KVCache


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another device.  With no card and no explicit device it raises —
    the port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        """Allocates the parameters (uninitialised) on ``device``; fill them
        with ``init`` or ``training/checkpoint.py::from_flat``."""
        super().__init__()
        if cfg.family != "dense" or not cfg.tie_embeddings:
            raise NotImplementedError(
                f"{cfg.name}: only tied dense decoders are ported")
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab, cfg.d_model), dtype=torch.float32,
                        device=dev), requires_grad=False)
        self.stacks = nn.ModuleList(Stack(cfg, period, reps, dev)
                                    for period, reps in cfg.stacks())
        self.ln_f = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=dev),
            requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def layers(self):
        return [blk for s in self.stacks for blk in s.layers]

    @torch.no_grad()
    def init(self, seed: int = 0) -> "Model":
        """Random weights drawn on the model's device from a seeded
        ``torch.Generator`` with the reference's initialiser scales
        (the numbers differ from ``jax.random``'s)."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)

        def normal_(p, std):
            p.copy_(torch.randn(p.shape, generator=gen, device=self.device,
                                dtype=torch.float32) * std)

        normal_(self.embed, 0.02)
        hd = cfg.resolved_head_dim
        wo_std = 1.0 / math.sqrt(cfg.n_heads * hd * 2 * cfg.n_layers)
        for blk in self.layers():
            for p in (blk.wq, blk.wk, blk.wv, *blk.mlp.values()):
                normal_(p, 1.0 / math.sqrt(p.shape[0]))
            normal_(blk.wo, wo_std)
        return self

    # ------------------------------------------------------------------
    def embed_inputs(self, batch: Dict):
        """(x (b, T, d), pos (b, T)); ``batch["pad"]`` (b,) left-pad counts
        turn pad slots into pos = -1 (masked from attention, scoring and
        the cache)."""
        dev = self.device
        tok = torch.as_tensor(np.asarray(batch["tokens"]), device=dev)
        x = embed(self.embed, tok, self.cfg.compute_dtype)
        b, t = tok.shape
        pos = torch.arange(t, dtype=torch.int32, device=dev).expand(b, t)
        pad = batch.get("pad")
        if pad is not None:
            pad = torch.as_tensor(np.asarray(pad), dtype=torch.int32,
                                  device=dev)
            pos = torch.where(torch.arange(t, device=dev)[None] < pad[:, None],
                              torch.full_like(pos, -1), pos)
        return x, pos

    def init_cache(self, batch: int, cap: int) -> List[List[KVCache]]:
        """One KV cache per layer, grouped by stack."""
        return [s.init_cache(batch, cap) for s in self.stacks]

    def _ctx(self, method: str) -> Dict:
        return {"method": method, "qcfg": self.cfg.quoka}

    def _apply_stacks(self, x, pos, cache, ctx):
        for s, sc in zip(self.stacks, cache):
            x = s.apply(x, pos, sc, ctx)
        return x

    def _readout(self, x):
        return unembed(self.embed, rmsnorm(self.ln_f, x, self.cfg.norm_eps))

    @torch.no_grad()
    def prefill(self, batch: Dict, cache, method: Optional[str] = None):
        """Chunked prefill of the whole prompt; the cache fills in place.
        Returns (last-position logits (b, V) fp32, cache)."""
        cfg = self.cfg
        method = method or cfg.quoka.method
        x_all, pos_all = self.embed_inputs(batch)
        t = x_all.shape[1]
        bcp = min(cfg.quoka.chunk_size, t)
        if t % bcp:
            raise ValueError(f"prompt length {t} must be a multiple of {bcp}")
        base = self._ctx(method)
        h = x_all
        for c0 in range(0, t, bcp):
            # write SLOT of the chunk — pad slots keep their slot, pos -1
            h = self._apply_stacks(x_all[:, c0:c0 + bcp],
                                   pos_all[:, c0:c0 + bcp], cache,
                                   dict(base, slot=c0))
        return self._readout(h[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens, pos: int, cache,
                    method: Optional[str] = None):
        """One decode step.  tokens (b,) on the model's device; pos an int
        (the slot and position of the new token).  Returns (logits (b, V),
        cache)."""
        cfg = self.cfg
        method = method or cfg.quoka.method
        b = tokens.shape[0]
        x = embed(self.embed, tokens[:, None], cfg.compute_dtype)
        pos2 = torch.full((b, 1), pos, dtype=torch.int32, device=self.device)
        x = self._apply_stacks(x, pos2, cache,
                               dict(self._ctx(method), slot=pos))
        return self._readout(x)[:, 0], cache


def build_model(cfg: ModelConfig, device=None, seed: int = 0) -> Model:
    """A model with random weights from ``seed`` on ``device`` (the card
    unless the caller passes another)."""
    return Model(cfg, device).init(seed)
