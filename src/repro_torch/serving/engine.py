"""Serving engine, one-shot batch mode (counterpart of
``repro/serving/engine.py``: ``Engine.__init__``, ``pad_prompt`` and
``generate``).  Continuous batching over a paged pool is not ported yet.

``generate`` runs the chunked prefill, samples the first token, then a
Python decode loop.  Kernel builds and a warm-up run on a throwaway cache
stay off the clocks; the clocks are host clocks around
``torch.cuda.synchronize()``, and tokens accumulate on the device with one
host copy after the loop.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.model import Model, resolve_device
from repro_torch.serving.sampler import SamplerConfig, sample


@dataclass
class GenerationResult:
    tokens: np.ndarray            # (b, max_new)
    ttft_s: float                 # time to first token (prefill + 1 sample)
    decode_tps: float             # decoded tokens/s across the batch
    prompt_len: int               # true prompt length (left pad excluded)
    method: str
    device: str


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    def __init__(self, model: Model, *, method: Optional[str] = None,
                 sampler: SamplerConfig = SamplerConfig(), device=None):
        """Serves ``model`` on ``device`` — the CUDA card unless the caller
        passes another; the model must already live there."""
        dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"model is on {model.device}, engine on {dev}")
        self.model = model
        self.device = dev
        self.method = method or model.cfg.quoka.method
        self.sampler = sampler
        self._warmed: set = set()

    def pad_prompt(self, tokens: np.ndarray) -> Dict[str, np.ndarray]:
        """Left-pad to a chunk multiple; the ``pad`` entry turns the pad
        slots into pos = -1 inside the model (masked everywhere)."""
        tokens = np.asarray(tokens)
        bcp = self.model.cfg.quoka.chunk_size
        pad = (-tokens.shape[1]) % bcp
        if pad:
            tokens = np.concatenate(
                [np.zeros((tokens.shape[0], pad), tokens.dtype), tokens], 1)
        return {"tokens": tokens,
                "pad": np.full((tokens.shape[0],), pad, np.int32)}

    def generate(self, batch: Dict, max_new: int, *,
                 generator: Optional[torch.Generator] = None
                 ) -> GenerationResult:
        """batch["tokens"]: (b, T) prompt with T % chunk_size == 0 (use
        ``pad_prompt``; its "pad" entry rides along)."""
        model, dev = self.model, self.device
        tokens = np.asarray(batch["tokens"])
        b, t = tokens.shape
        cap = t + max_new
        g = model.cfg.quoka.granularity
        if self.method != "full" and g > 1:
            cap = -(-cap // g) * g     # block plans need the cache on the grid
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)

        # first call on a signature: build the kernels and warm every path
        # on a throwaway cache, off the clocks
        sig = (b, t, cap, max_new > 1, batch.get("pad") is not None)
        if sig not in self._warmed:
            wgen = torch.Generator(device=dev)
            wcache = model.init_cache(b, cap)
            wl, wcache = model.prefill(batch, wcache, self.method)
            wt = sample(wl, wgen, self.sampler)
            if max_new > 1:
                wl, wcache = model.decode_step(wt, t, wcache, self.method)
                sample(wl, wgen, self.sampler)
            _sync(dev)
            del wcache
            self._warmed.add(sig)

        cache = model.init_cache(b, cap)
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(batch, cache, self.method)
        tok = sample(logits, generator, self.sampler)
        _sync(dev)
        ttft = time.perf_counter() - t0

        out = [tok]
        t1 = time.perf_counter()
        pos = t
        for _ in range(max_new - 1):
            logits, cache = model.decode_step(tok, pos, cache, self.method)
            tok = sample(logits, generator, self.sampler)
            out.append(tok)
            pos += 1
        _sync(dev)
        dt = time.perf_counter() - t1
        tps = (b * (max_new - 1)) / dt if max_new > 1 and dt > 0 else 0.0
        tokens_out = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        pad = batch.get("pad")
        prompt_len = t - (int(np.asarray(pad).reshape(-1)[0])
                          if pad is not None else 0)
        return GenerationResult(tokens=tokens_out, ttft_s=ttft,
                                decode_tps=tps, prompt_len=prompt_len,
                                method=self.method, device=str(dev))
