"""Layer stack (counterpart of ``repro/models/stack.py``).

The reference scans one compiled block body over a stacked ``(repeats,
...)`` parameter axis; eager PyTorch runs a Python loop over an
``nn.ModuleList`` instead, layer ``i`` holding row ``i`` of the reference's
stacked leaves (see ``training/checkpoint.py::from_flat``).  The loop
threads the cross-layer plan carry and each layer's global index.  A
period may mix kinds; each layer's cache is a ``KVCache`` (attention
kinds; a ring of ``min(cap, window)`` slots for ``attn_local``, so one
stack mixes capacities), a ``LatentCache`` (MLA), a ``MambaCache``
(``mamba``), a ``SharedAttnCache`` (``mamba_shared_attn``: the Mamba2
state and the shared block's KV cache), an ``RWKVCache`` (``rwkv``) or
a ``CrossCache`` (``dec_cross``: the self-attention's KV cache and the
cross-attention's keys and values of the encoder's output), all updated
in place.  ``full_forward`` is the full-sequence pass with no cache (the
reference's ``Stack.train``: training, and whisper's encoder), each layer
recomputed in the backward under ``cfg.remat`` as the reference's
``jax.checkpoint`` does (on a mesh every rank re-runs the layer's
forward collectives in the backward, in one order, counted under the
byte label ``remat``).  The plan carry engages only where every layer
would build a plan of one shape, as in the reference: a plain ``mamba`` or
``rwkv`` layer builds none, which turns it off for its stack.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import plan as plan_mod
from repro_torch.models.blocks import make_block
from repro_torch.sharding import comm
from repro_torch.serving.cache import (CrossCache, KVCache, LatentCache,
                                       MambaCache, RWKVCache, SharedAttnCache)

Cache = Union[KVCache, LatentCache, MambaCache, SharedAttnCache, RWKVCache,
              CrossCache]


def _recomputed(fn):
    """``fn`` whose second and later calls (the checkpoint's recompute in
    the backward) count their collectives under ``remat``."""
    calls = [0]

    def run(*args):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*args)
        with comm.label("remat"):
            return fn(*args)
    return run


class Stack(nn.Module):
    def __init__(self, cfg: ModelConfig, period: Sequence[str], repeats: int,
                 device):
        super().__init__()
        self.cfg = cfg
        self.period = tuple(period)
        self.repeats = repeats
        # layer order: repeat r, period position j -> index r * len(period) + j
        self.layers = nn.ModuleList(
            make_block(cfg, kind, device) for _ in range(repeats)
            for kind in self.period)

    def full_forward(self, x, pos, ctx=None):
        """Every layer's full-sequence pass with no cache and no plan
        carry.  Returns (x, aux): the layers' aux losses summed in fp32.
        Under ``cfg.remat`` (with autograd recording) each layer keeps only
        its input and runs again in the backward, where its collectives
        count under the byte label ``remat``."""
        ctx = {} if ctx is None else ctx
        remat = self.cfg.remat and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.layers:
            if remat:
                # the blocks draw no random numbers: no RNG state to keep
                x, a = checkpoint(_recomputed(blk.full_forward), x, pos, ctx,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = blk.full_forward(x, pos, ctx)
            aux = aux + a
        return x, aux

    def init_cache(self, batch: int, cap: int, seq=None) -> List[Cache]:
        if seq is None:
            return [blk.init_cache(batch, cap) for blk in self.layers]
        return [blk.init_cache(batch, cap, seq) for blk in self.layers]

    def _plan_carry0(self, caches: List[Cache], t: int, ctx, plan, device):
        """The initial plan carry, or None when reuse is off: it engages
        only with ``reuse_interval > 1`` and when every layer would build a
        plan of the same shape (else every layer builds its own).  An
        incoming carry of that shape (from the previous stack) is
        adopted."""
        qcfg = ctx.get("qcfg")
        method = ctx.get("method", "full")
        if qcfg is None or method == "full" or max(1, qcfg.reuse_interval) <= 1:
            return None
        shapes = [blk.plan_carry_shape(kv, t, method, qcfg)
                  for blk, kv in zip(self.layers, caches)]
        if shapes[0] is None or any(s != shapes[0] for s in shapes):
            return None
        if isinstance(plan, plan_mod.PlanCarry) and \
                tuple(plan.idx.shape) == shapes[0]:
            return plan
        return plan_mod.empty_carry(shapes[0], device)

    def apply(self, x, pos, caches: List[Cache], ctx, plan=None):
        """Prefill chunk or decode step through every layer; caches are
        updated in place.  ``ctx["layer0"]`` is this stack's first global
        layer index.  Returns (x, plan carry, obs, sel): the carry passes
        through untouched when reuse is off here.  ``obs``, with
        ``ctx["obs"]`` set, is one ``LayerObs`` per layer in global layer
        order (``nan_obs`` for a layer that leaves none: mamba, rwkv; on
        a mesh each layer's ``MeshObs`` partials instead), else None.  ``sel`` is the prefetch oracle's side channel: with
        ``ctx["selblk"] = (block_size, n_blocks)`` set, the (b, n_blocks)
        int32 sum over this stack's layers of each plan's
        ``pool_block_counts`` (a layer that selected nothing adds zero),
        else None."""
        carry = self._plan_carry0(caches, x.shape[1], ctx, plan, x.device)
        layer0 = int(ctx.get("layer0", 0))
        obs_on = bool(ctx.get("obs"))
        sel_on = ctx.get("selblk") is not None
        obs = [] if obs_on else None
        sel = None
        for i, (blk, kv) in enumerate(zip(self.layers, caches)):
            # a per-layer copy when the layer leaves something in it
            cj = ctx if carry is None and not obs_on and not sel_on else \
                dict(ctx, layer_idx=layer0 + i)
            x, carry = blk.apply(x, pos, kv, cj, plan=carry)
            if obs_on:
                ob = cj.pop("_obs", None)
                obs.append(plan_mod.missing_obs(cj, x.device)
                           if ob is None else ob)
            if sel_on:
                sb = cj.pop("_selblk", None)
                if sel is None:
                    sel = torch.zeros((x.shape[0], ctx["selblk"][1]),
                                      dtype=torch.int32, device=x.device)
                if sb is not None:
                    sel += sb
        return x, (plan if carry is None else carry), obs, sel
