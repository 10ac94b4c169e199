"""Decoder model: embedding, layer stacks, read-out (counterpart of
``repro/models/model.py``, families ``"dense"``, ``"moe"``, ``"hybrid"``
(zamba2: Mamba2 layers and one shared attention block, ``shared``, which
the model owns once and hands to its layers in ``ctx["shared"]``),
``"ssm"`` (rwkv6), ``"audio"`` (whisper) and ``"vlm"`` (internvl2)).  A
model without rope (rwkv6, whisper) adds a sinusoidal embedding of each
position to its input embeddings (pad slots at position -1, as the
reference); recurrent blocks see pad embeddings in sequence, as the
reference's do.

The modality frontends are stubs, as in the reference: the batch brings
their embeddings.  Whisper (``"audio"``) runs its encoder (``enc``:
``enc_attn`` layers, one bidirectional pass over ``batch["frames"]`` (b,
n_ctx, d) plus their sinusoidal positions, then RMSNorm ``enc_ln``, as
the reference's ``rmsnorm`` there although its blocks use LayerNorm) at
the start of ``prefill``, and writes every ``dec_cross`` layer's
cross-attention keys and values of its output into that layer's cache
(``_build_cross``), which ``prefill_chunk`` and ``decode_step`` then
read.  Internvl2 (``"vlm"``) projects ``batch["patches"]`` (b, n, d_in)
with ``proj`` (gelu(tanh) of ``fc1``, then ``fc2``, both with bias) and
puts them before the token embeddings; positions run over the whole
sequence, so decode starts at n + T.

Entry points: ``prefill`` (chunked prefill, paper Algorithm 2: a Python
loop over chunks, each selecting from the KV cache per layer),
``prefill_chunk`` (one chunk with per-row starts and valid lengths: the
continuous-batching unit) and ``decode_step``; the last two can return
the host tier's prefetch oracle (``sel_blocks``).  They run under
``torch.no_grad``.  Training: ``train_logits`` (every stack's
full-sequence pass, no cache, the plain attention path) and ``loss``
(next-token cross entropy plus the MoE aux loss and DeepSeek's
multi-token-prediction loss, ``_mtp_loss``, through the ``mtp`` head);
the parameters are created with ``requires_grad=False`` and a trainer
turns them on (``training/loop.py::init_state``).  The read-out is tied
to the embedding or, untied, ``lm_head`` (fp32, as the reference applies
it).  ``prefill_chunk`` and ``decode_step`` can also return the per-layer
``LayerObs`` (``with_obs``), stacked into (n_layers,) leaves.

Tensor parallelism: ``training/checkpoint.py::shard`` slices a model's
weights for one rank of a ``model`` mesh axis (``mesh`` then names it);
a vocab-sharded model (``tp_vocab``, the axis) looks its embeddings up
with a masked lookup and a sum over the ranks, and gathers the vocab
shards' logits in ``_readout``, so every rank samples from the same
logits.  Weights are drawn (``init``) before they are sliced.  Under
FSDP (``fsdp``, the flattened ``(pod, data)`` axis; ``layers.py``) the
lookup reads the embedding rows its tokens need from every FSDP rank's
columns, and ``_readout`` returns the logits of EVERY FSDP rank's rows,
in rank order: rows split over the FSDP ranks come back as the whole
batch, rows every rank holds come back once per rank.  ``init_cache(...,
seq=)`` splits a batch-1 cache's sequence over a mesh axis.  The
attention-and-MoE and MLA families shard too (``attn_moe``, ``mla``,
``mla_moe``: expert-parallel MoE, MLA's heads), and so do the
sliding-window and recurrent kinds (``attn_local``, ``mamba``,
``mamba_shared_attn``, ``rwkv``: their heads over ``model``; zamba2's
``shared`` block is placed once), and the modality families: whisper's
encoder layers and ``dec_cross`` layers (heads over ``model``; at batch
1 every ``data`` rank runs the whole encoder over the whole frames and
keeps its slice of them in each ``CrossKV``) and internvl2's projector
(its rows FSDP-cut, gathered per call); deepseek's untied
``lm_head`` is vocab-parallel and FSDP-cut like the embedding, and its
``mtp`` head is placed with the layers and never run at inference.
With ``with_obs`` on a mesh each selecting layer leaves its raw partials
and the step reduces them over the mesh once (``core/plan.py::
MeshObs``), so every rank returns the meshless ``LayerObs``.  Training
on a mesh (``training/loop.py``): ``train_logits`` and ``loss`` take
``rows``, the FSDP axis when the batch is this rank's share of the
step's rows; the logits are this rank's rows, and the loss (MTP's and
the MoE's aux loss too) is the whole step's, the same on every rank.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import LayerObs, MeshObs
from repro_torch.models.blocks import (AttnBlock, DecCrossBlock,
                                      MambaBlock, RWKVBlock, _weight,
                                      make_block)
from repro_torch.models.layers import (_act, embed, gather_weights,
                                       linear, readout, rmsnorm,
                                       sinusoidal)
from repro_torch.models.stack import Cache, Stack
from repro_torch.sharding import comm


def _on(x, dev, dtype=None) -> torch.Tensor:
    """A host array or a tensor as a tensor on ``dev``."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=dtype, device=dev)


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


class MTPHead(nn.Module):
    """DeepSeek-V3's multi-token-prediction head: one extra block (MLA
    when the model has MLA) fed ``mix([norm(h_t); emb(tok_t+1)])``; a
    training-time loss (``Model._mtp_loss``), run at no inference entry
    point."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        self.block = make_block(cfg, "mla" if cfg.mla else "attn", device)
        self.ln = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                          device=device),
                               requires_grad=False)
        self.mix = nn.Parameter(torch.empty((2 * d, d),
                                            dtype=cfg.compute_dtype,
                                            device=device),
                                requires_grad=False)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        """Allocates the parameters (uninitialised) on ``device``; fill them
        with ``init`` or ``training/checkpoint.py::from_flat``."""
        super().__init__()
        if cfg.family not in ("dense", "moe", "hybrid", "ssm", "audio",
                              "vlm"):
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
        if (cfg.encoder is not None) != (cfg.family == "audio") or \
                (cfg.frontend is not None) != (cfg.family == "vlm"):
            raise ValueError(f"{cfg.name}: an encoder belongs to family "
                             f"'audio' and a frontend to family 'vlm' only")
        dev = resolve_device(device)
        self.cfg = cfg
        self.mesh = None           # the mesh a ``shard`` placed this on
        self.tp_vocab = None       # the model axis when the vocab shards
        self.fsdp = None           # the FSDP axis (``shard``, pod x data)
        self.cuts = {}             # parameter -> (model dim, FSDP dim) cut
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab, cfg.d_model), dtype=torch.float32,
                        device=dev), requires_grad=False)
        self.stacks = nn.ModuleList(Stack(cfg, period, reps, dev)
                                    for period, reps in cfg.stacks())
        self.ln_f = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=dev),
            requires_grad=False)
        # untied read-out, fp32 as the reference applies it
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty((cfg.d_model, cfg.vocab), dtype=torch.float32,
                        device=dev), requires_grad=False)
        self.mtp = MTPHead(cfg, dev) if cfg.mtp else None
        # zamba2's shared attention block: one set of weights for every
        # ``mamba_shared_attn`` layer, which passes its own KV cache
        self.shared = AttnBlock(cfg, dev, "attn") \
            if "mamba_shared_attn" in cfg.layer_kinds() else None
        # whisper's encoder: its stack of enc_attn layers and the final
        # norm (RMSNorm, as the reference's)
        self.enc = self.enc_ln = None
        if cfg.family == "audio":
            self.enc = Stack(cfg, ("enc_attn",), cfg.encoder.n_layers, dev)
            self.enc_ln = nn.Parameter(
                torch.ones(cfg.d_model, dtype=torch.float32, device=dev),
                requires_grad=False)
        # internvl2's projector of patch embeddings into the LM's space
        self.proj = None
        if cfg.family == "vlm":
            d, d_in = cfg.d_model, cfg.frontend.d_in
            w = _weight(cfg.compute_dtype, dev)
            self.proj = nn.ParameterDict({
                "fc1_w": w(d_in, d), "fc1_b": w(d),
                "fc2_w": w(d, d), "fc2_b": w(d)})

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
        if self.mesh is not None:
            raise ValueError("draw the weights before sharding the model")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)

        def normal_(p, std):
            p.copy_(torch.randn(p.shape, generator=gen, device=self.device,
                                dtype=torch.float32) * std)

        def uniform_(p, lo, hi):
            p.copy_(torch.rand(p.shape, generator=gen, device=self.device,
                               dtype=torch.float32) * (hi - lo) + lo)

        normal_(self.embed, 0.02)
        enc = list(self.enc.layers) if self.enc is not None else []
        for blk in self.layers() + enc:
            if isinstance(blk, MambaBlock):
                blk.mamba.init(normal_, uniform_)
            elif isinstance(blk, RWKVBlock):
                blk.tm.init(normal_, cfg)
                blk.cm.init(normal_, cfg)
            elif isinstance(blk, DecCrossBlock):
                self._init_block(blk.self_attn, normal_)
                for p in (blk.xq, blk.xk, blk.xv, blk.xo):
                    normal_(p, 1.0 / math.sqrt(p.shape[0]))
            else:
                self._init_block(blk, normal_)
        if self.proj is not None:
            for name in ("fc1", "fc2"):
                wt = self.proj[name + "_w"]
                normal_(wt, 1.0 / math.sqrt(wt.shape[0]))
                self.proj[name + "_b"].zero_()
        if self.shared is not None:
            self._init_block(self.shared, normal_)
        if self.lm_head is not None:
            normal_(self.lm_head, 1.0 / math.sqrt(cfg.d_model))
        if self.mtp is not None:
            self._init_block(self.mtp.block, normal_)
            normal_(self.mtp.mix, 1.0 / math.sqrt(2 * cfg.d_model))
        return self

    def _init_block(self, blk, normal_) -> None:
        """One block's leaves at the reference's scales: linear weights
        1/sqrt(d_in), MLA's decompression weights 1/sqrt(kv_lora_rank), the
        output projection 1/sqrt(its fan-in * 2 * n_layers)."""
        cfg = self.cfg
        ffn = list(blk.mlp.values()) if hasattr(blk, "mlp") else []
        if isinstance(blk, AttnBlock):
            fan_in = cfg.n_heads * cfg.resolved_head_dim
            for p in (blk.wq, blk.wk, blk.wv, *ffn):
                normal_(p, 1.0 / math.sqrt(p.shape[0]))
        else:
            m = cfg.mla
            fan_in = cfg.n_heads * m.v_head_dim
            for p in (blk.wq_a, blk.wq_b, blk.wkv_a, *ffn):
                normal_(p, 1.0 / math.sqrt(p.shape[0]))
            for p in (blk.wk_b, blk.wv_b):
                normal_(p, 1.0 / math.sqrt(m.kv_lora_rank))
        if hasattr(blk, "moe"):
            blk.moe.init(normal_)
        normal_(blk.wo, 1.0 / math.sqrt(fan_in * 2 * cfg.n_layers))

    # ------------------------------------------------------------------
    def embed_inputs(self, batch: Dict):
        """(x (b, T, d), pos (b, T)); ``batch["pad"]`` (b,) left-pad counts
        turn pad slots into pos = -1 (masked from attention, scoring and
        the cache; a recurrent block still reads their embeddings).  A
        VLM's projected ``batch["patches"]`` come first (T counts them);
        it takes no padding, as the reference."""
        dev = self.device
        tok = _on(batch["tokens"], dev)
        x = self._embed(tok)
        if self.proj is not None:
            if batch.get("pad") is not None:
                raise ValueError("left-padding unsupported for VLM inputs")
            x = torch.cat([self.project(batch["patches"]), x], dim=1)
        b, t = x.shape[:2]
        pos = torch.arange(t, dtype=torch.int32, device=dev).expand(b, t)
        pad = batch.get("pad")
        if pad is not None:
            pad = _on(pad, dev, torch.int32)
            pos = torch.where(torch.arange(t, device=dev)[None] < pad[:, None],
                              torch.full_like(pos, -1), pos)
        return self._positional(x, pos), pos

    def project(self, patches):
        """The VLM projector: patch embeddings (b, n, d_in) -> (b, n, d):
        gelu(tanh) of ``fc1``, then ``fc2``, in the compute dtype.  The
        weights' rows that FSDP cut are gathered whole for the call, in
        one all-gather."""
        p = dict(self.proj.items())
        rows = {"fc1_w": self.cfg.frontend.d_in, "fc2_w": self.cfg.d_model}
        cut = {k: (p[k], 0) for k, n in rows.items() if p[k].shape[0] < n}
        if cut:
            p.update(gather_weights(cut, self.fsdp))
        pe = _on(patches, self.device, self.cfg.compute_dtype)
        h = _act("gelu", linear(p["fc1_w"], pe, p["fc1_b"]))
        return linear(p["fc2_w"], h, p["fc2_b"])

    def encode(self, frames):
        """Whisper's encoder over stub frame embeddings (b, n_ctx, d): the
        frames plus their sinusoidal positions, one bidirectional pass
        through the ``enc_attn`` stack, then ``enc_ln`` (RMSNorm)."""
        dt = self.cfg.compute_dtype
        x = _on(frames, self.device, dt)
        b, s = x.shape[:2]
        pos = torch.arange(s, dtype=torch.int32,
                           device=self.device).expand(b, s)
        x, _ = self.enc.full_forward(
            x + sinusoidal(pos, self.cfg.d_model, dt), pos)
        return rmsnorm(self.enc_ln, x, self.cfg.norm_eps)

    def _build_cross(self, cache, enc_out) -> None:
        """Write every ``dec_cross`` layer's cross-attention keys and
        values of ``enc_out`` into its cache's ``CrossKV``, in place, in
        the compute dtype (on a mesh its KV heads and, split over
        ``data``, its frames: ``DecCrossBlock.write_cross``)."""
        for s, sc in zip(self.stacks, cache):
            for blk, c in zip(s.layers, sc):
                if isinstance(blk, DecCrossBlock):
                    blk.write_cross(c.cross, enc_out)

    def _positional(self, x, pos):
        """x plus the sinusoidal embedding of ``pos`` when the model has
        no rope (rwkv6, whisper), else x."""
        if self.cfg.use_rope:
            return x
        return x + sinusoidal(pos, self.cfg.d_model, x.dtype)

    def init_cache(self, batch: int, cap: int,
                   seq=None) -> List[List[Cache]]:
        """One cache per layer (``KVCache``, ``LatentCache`` for MLA,
        ``CrossCache`` for whisper's decoder, or a recurrent state:
        ``MambaCache``, ``SharedAttnCache``, ``RWKVCache``), grouped by
        stack.  A VLM's ``cap`` counts its patch positions.  ``seq`` (a
        mesh axis) splits each KV or latent cache's capacity axis over
        it where it divides it, this rank holding its contiguous slice (a
        recurrent state has no sequence axis and stays whole)."""
        return [s.init_cache(batch, cap, seq) for s in self.stacks]

    def _ctx(self, method: str) -> Dict:
        ctx = {"method": method, "qcfg": self.cfg.quoka}
        if self.shared is not None:
            ctx["shared"] = self.shared
        return ctx

    def _apply_stacks(self, x, pos, cache, ctx):
        """All stacks in order, threading the cross-layer plan carry and
        the global layer offset (the reuse schedule spans stacks).
        Returns (x, obs, sel): ``obs`` is the per-layer ``LayerObs`` with
        (n_layers,) fp32 leaves in global layer order when ``ctx["obs"]``
        is set (``core/plan.py``; on a mesh the layers' partials reduced
        over it once, ``MeshObs.reduce``), else None; ``sel`` sums the stacks'
        prefetch-oracle counts when ``ctx["selblk"]`` is set, else None."""
        plan, layer0, sel = None, 0, None
        obs = [] if ctx.get("obs") else None
        for s, sc in zip(self.stacks, cache):
            x, plan, ob, ss = s.apply(x, pos, sc, dict(ctx, layer0=layer0),
                                      plan=plan)
            if obs is not None:
                obs.extend(ob)
            if ss is not None:
                sel = ss if sel is None else sel + ss
            layer0 += len(s.layers)
        if isinstance(ctx.get("obs"), MeshObs):
            obs = ctx["obs"].reduce(obs)
        elif obs is not None:
            obs = LayerObs(*(torch.stack(f) for f in zip(*obs)))
        return x, obs, sel

    def _embed(self, tok, dtype=None):
        """Token embeddings in ``dtype`` (default the compute dtype): a
        vocab-parallel lookup under ``tp_vocab``."""
        ax = self.tp_vocab
        dt = self.cfg.compute_dtype if dtype is None else dtype
        fax = self.fsdp if self.fsdp is not None and \
            self.embed.shape[1] < self.cfg.d_model else None
        if ax is None:
            return embed(self.embed, tok, dt, fax=fax)
        return embed(self.embed, tok, dt, ax, ax.rank * self.embed.shape[0],
                     fax=fax)

    def _readout(self, x):
        x = rmsnorm(self.ln_f, x, self.cfg.norm_eps)
        tied = self.lm_head is None
        return readout(self.embed if tied else self.lm_head, x, self.fsdp,
                       self.tp_vocab, tied=tied)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def train_logits(self, batch: Dict, rows=None):
        """Full-sequence logits (b, T, V) fp32 of the batch's rows and the
        aux loss (fp32 scalar: MoE load balance plus MTP).  Whisper first
        runs its encoder over ``batch["frames"]``; a VLM's T counts its
        patches.  ``rows``: the FSDP axis when the batch is this rank's
        share of the step's rows (rank-major), else None; the aux loss is
        then the whole step's (a MoE's routed fractions and its MTP mean
        count every rank's rows)."""
        enc_out = self.encode(batch["frames"]) if self.enc is not None \
            else None
        x, pos = self.embed_inputs(batch)
        ctx = {"shared": self.shared, "enc_out": enc_out, "rows": rows}
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for s in self.stacks:
            x, a = s.full_forward(x, pos, ctx)
            aux = aux + a
        logits = self._own_rows(self._readout(x), x.shape[0])
        if self.mtp is not None:
            aux = aux + self._mtp_loss(x, pos, batch, ctx)
        return logits, aux

    def _own_rows(self, logits, b: int):
        """This rank's ``b`` rows of ``_readout``'s logits, which under
        FSDP are every FSDP rank's rows in rank order."""
        if self.fsdp is None:
            return logits
        return logits[self.fsdp.rank * b:(self.fsdp.rank + 1) * b]

    def _mtp_loss(self, hidden, pos, batch: Dict, ctx: Dict):
        """DeepSeek-V3 multi-token prediction: the ``mtp`` block predicts
        token t+2 from ``mix([norm(h_t); emb(tok_t+1)])``; weight 0.3, the
        mean over every position with the last two masked (as the
        reference, which divides by all b * T; over every rank's rows
        when ``ctx["rows"]`` splits them)."""
        cfg = self.cfg
        tok = _on(batch["tokens"], self.device).long()
        emb_n = self._embed(torch.roll(tok, -1, dims=1), hidden.dtype)
        h = rmsnorm(self.mtp.ln, hidden, cfg.norm_eps)
        mix = self.mtp.mix
        if mix.shape[0] < 2 * cfg.d_model:       # FSDP cut its rows
            mix = gather_weights({"mix": (mix, 0)}, self.fsdp)["mix"]
        h = linear(mix, torch.cat([h, emb_n], dim=-1))
        h, _ = self.mtp.block.full_forward(h, pos, ctx)
        logits = self._own_rows(self._readout(h), h.shape[0])
        t = tok.shape[1]
        nll = F.cross_entropy(logits.flatten(0, 1),
                              torch.roll(tok, -2, dims=1).flatten(),
                              reduction="none").view(tok.shape)
        mask = torch.arange(t, device=self.device) < t - 2
        rows = ctx.get("rows")
        if rows is None or rows.size == 1:
            return 0.3 * (nll * mask[None]).mean()
        with comm.scope("loss"):
            total = comm.all_reduce((nll * mask[None]).sum(), rows)
        return 0.3 * total / (nll.numel() * rows.size)

    def loss(self, batch: Dict, rows=None):
        """Next-token cross entropy plus the aux loss, a fp32 scalar.  A
        VLM's patch positions are dropped from the logits; whisper's loss
        is over its decoder tokens; ``batch["loss_mask"]`` (b, T) weights
        the positions (averaged over its sum, at least 1).  ``rows`` as
        ``train_logits``': the mean is then the whole step's, the sums of
        ``nll * mask`` and of the mask over ``rows``, on every rank."""
        logits, aux = self.train_logits(batch, rows)
        tok = _on(batch["tokens"], self.device).long()
        t = tok.shape[1]
        lg = logits[:, -t:-1] if self.proj is not None else logits[:, :-1]
        nll = F.cross_entropy(lg.flatten(0, 1), tok[:, 1:].flatten(),
                              reduction="none").view(tok.shape[0], t - 1)
        mask = batch.get("loss_mask")
        if rows is not None and rows.size > 1:
            m = torch.ones_like(nll) if mask is None else \
                _on(mask, self.device, torch.float32)[:, 1:]
            with comm.scope("loss"):
                sums = comm.all_reduce(torch.stack([(nll * m).sum(),
                                                    m.sum()]), rows)
            return sums[0] / sums[1].clamp(min=1.0) + aux
        if mask is None:
            return nll.mean() + aux
        m = _on(mask, self.device, torch.float32)[:, 1:]
        return (nll * m).sum() / m.sum().clamp(min=1.0) + aux

    @torch.no_grad()
    def prefill(self, batch: Dict, cache, method: Optional[str] = None,
                rows=None):
        """Chunked prefill of the whole prompt; the cache fills in place.
        Whisper first runs its encoder over ``batch["frames"]`` and builds
        the cross-attention keys and values (so its TTFT includes the
        encoder, as the reference's).  ``rows``: the FSDP axis when the
        batch is this rank's share of its rows (rank-major; a MoE's
        capacity counts every rank's tokens), else None.  Returns
        (last-position logits (b, V) fp32, cache)."""
        cfg = self.cfg
        method = method or cfg.quoka.method
        if self.enc is not None:
            self._build_cross(cache, self.encode(batch["frames"]))
        x_all, pos_all = self.embed_inputs(batch)
        t = x_all.shape[1]
        bcp = min(cfg.quoka.chunk_size, t)
        if t % bcp:
            raise ValueError(f"prompt length {t} must be a multiple of {bcp}")
        base = dict(self._ctx(method), rows=rows)
        h = x_all
        for c0 in range(0, t, bcp):
            # write SLOT of the chunk — pad slots keep their slot, pos -1
            h, _, _ = self._apply_stacks(x_all[:, c0:c0 + bcp],
                                      pos_all[:, c0:c0 + bcp], cache,
                                      dict(base, slot=c0))
        return self._readout(h[:, -1:])[:, 0], cache

    @torch.no_grad()
    def prefill_chunk(self, batch: Dict, pos_start, cache,
                      method: Optional[str] = None, valid_len=None,
                      with_obs: bool = False, sel_blocks=None, rows=None):
        """One B_CP chunk through all stacks: the unit of per-chunk dispatch
        under continuous batching.  batch["tokens"]: (b, B_CP) chunk (a
        host array or a tensor, as ``valid_len``);
        ``pos_start`` an int or a per-row (b,) tensor (each request's chunk
        starts at its own offset; it is also the write slot).  ``valid_len``
        (b,) marks how many leading chunk tokens are real: the rest get
        pos = -1 and are masked everywhere.  Returns (last VALID hidden
        state (b, d), cache); ``with_obs=True`` appends the per-layer
        ``LayerObs`` ((n_layers,) fp32 leaves on the device; the selection
        itself is unchanged), and ``sel_blocks = (block_size, n_blocks)``
        then appends the prefetch oracle's output, the (b, n_blocks) int32
        selection counts per logical pool block summed over layers
        (``core/plan.py::pool_block_counts``); ``rows`` as ``prefill``'s."""
        method = method or self.cfg.quoka.method
        dev = self.device
        tok = _on(batch["tokens"], dev)
        x = self._embed(tok)
        b, t = tok.shape
        offs = torch.arange(t, dtype=torch.int32, device=dev)
        if isinstance(pos_start, torch.Tensor) and pos_start.ndim == 1:
            slot = pos_start.to(device=dev, dtype=torch.int32)
            pos = slot[:, None] + offs[None]
        else:
            slot = int(pos_start)
            pos = (slot + offs)[None].expand(b, t)
        if valid_len is not None:
            vl = _on(valid_len, dev, torch.int32)
            pos = torch.where(offs[None] < vl[:, None], pos,
                              torch.full_like(pos, -1))
        x = self._positional(x, pos)
        ctx = self._step_ctx(method, slot, with_obs, sel_blocks, rows)
        x, obs, sel = self._apply_stacks(x, pos, cache, ctx)
        if valid_len is None:
            last = x[:, -1]
        else:
            li = (vl.long() - 1).clamp(0, t - 1)
            last = x[torch.arange(b, device=dev), li]
        return _step_out(last, cache, obs, sel)

    @torch.no_grad()
    def decode_step(self, tokens, pos, cache,
                    method: Optional[str] = None, with_obs: bool = False,
                    sel_blocks=None, rows=None):
        """One decode step.  tokens (b,) on the model's device; pos an int
        or a per-row (b,) tensor (continuous batching): the slot and
        position of each new token.  Returns (logits (b, V), cache), plus
        the per-layer ``LayerObs`` when ``with_obs=True`` and the selection
        counts when ``sel_blocks`` is set (see ``prefill_chunk``; obs
        first); ``rows`` as ``prefill``'s."""
        cfg = self.cfg
        method = method or cfg.quoka.method
        b = tokens.shape[0]
        x = self._embed(tokens[:, None])
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            slot = pos.to(device=self.device, dtype=torch.int32)
            pos2 = slot[:, None]
        else:
            slot = int(pos)
            pos2 = torch.full((b, 1), slot, dtype=torch.int32,
                              device=self.device)
        x = self._positional(x, pos2)
        ctx = self._step_ctx(method, slot, with_obs, sel_blocks, rows)
        x, obs, sel = self._apply_stacks(x, pos2, cache, ctx)
        return _step_out(self._readout(x)[:, 0], cache, obs, sel)

    def _step_ctx(self, method: str, slot, with_obs: bool, sel_blocks,
                  rows=None):
        ctx = dict(self._ctx(method), slot=slot, rows=rows)
        if with_obs:
            ctx["obs"] = True if self.mesh is None else \
                MeshObs(self.mesh, rows is not None)
        if sel_blocks is not None:
            ctx["selblk"] = (int(sel_blocks[0]), int(sel_blocks[1]))
        return ctx


def _step_out(head, cache, obs, sel):
    """(head, cache) plus the side outputs that were asked for, obs
    first, as the reference orders them."""
    return (head, cache) + tuple(o for o in (obs, sel) if o is not None)


def build_model(cfg: ModelConfig, device=None, seed: int = 0) -> Model:
    """A model with random weights from ``seed`` on ``device`` (the card
    unless the caller passes another)."""
    return Model(cfg, device).init(seed)
