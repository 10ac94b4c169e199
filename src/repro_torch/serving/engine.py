"""Serving engine (counterpart of ``repro/serving/engine.py``).  Two
serving modes share the model and the kernel facade:

  * ``generate`` — one synchronous batch: the chunked prefill, the first
    sampled token, then a Python decode loop.  Tokens accumulate on the
    device with one host copy after the loop.
  * ``step`` / ``serve_stream`` / ``serve`` — continuous batching: a paged
    KV pool (serving/pool.py) plus a request-lifecycle scheduler
    (serving/scheduler.py) drive two step functions — a mixed
    chunk-prefill step and a batched decode step — each of which gathers
    the step's requests' blocks through their block tables into a linear
    cache view, runs the model on it, samples, and scatters the touched
    blocks back, as the reference does.  The model's selecting layers
    therefore run the linear-view kernels; the paged kernel
    (``ops.selected_attention(table=)``) is not on this path, in the
    reference either.

Both modes take every selection method of ``core/selection.py::METHODS``,
and cross-layer plan reuse and low-rank scoring from the model's
``QuokaConfig``.  Kernel builds and a warm-up run stay off the clocks in
both modes; the
clocks are host clocks around a device synchronisation.

With the host-memory tier on (``host_tier_blocks``), the step functions
also return the plans' selection counts per logical pool block
(``core/plan.py::pool_block_counts``, summed over layers) stacked beside
the sampled tokens, so both reach the host in the step's one copy.  The
engine folds them into a decayed hotness per logical block and, while a
step is dispatched and before that copy, stages the next waiting request's
hottest host-tier blocks (``_prefetch``): their H2D copies run on a side
stream under the step's compute.

``Engine(registry=)`` (``obs.Registry``) turns on serve-path telemetry as
the reference does: step spans bracketing each step function through its
token fetch, scheduler and pool counters and gauges, and the per-layer
``LayerObs`` (``core/plan.py``), which the step functions then return
beside the tokens and the engine fetches in one stacked copy per step
after the token fetch.  With no registry the step functions run without
them, exactly as before.  ``Engine.stats`` is a view of the registry
either way (an ephemeral one when off).

``Engine(mesh=)`` (a ``DeviceMesh``, ``launch/mesh.py``) serves on the
mesh, one process per rank: tensor-parallel over its ``model`` axis and
data-parallel over its FSDP axes ``(pod, data)``.  The model is sharded
at construction (``training/checkpoint.py::shard``: every weight's embed
axis cut over the FSDP group too, gathered per layer call) and
``generate`` / ``serve`` run under the mesh policy (``sharding/ctx.py``),
every rank on its own shards with the collectives of
``sharding/comm.py``.  ``generate`` places the batch as
``specs.batch_spec`` / ``cache_specs`` do (``_layout``): rows split over
the FSDP ranks when they divide the batch; else every rank runs every
row, and a cache whose capacity the ``data`` axis divides holds its
sequence split over ``data`` (a batch-1 prompt), selected where it lies
(``core/plan.py``).  The read-out gives every rank the whole batch's
logits, which every rank samples with the same generator, so every rank
returns the same tokens, the meshless run's draws.  ``serve`` splits the
pool's blocks and each step's rows over the FSDP ranks: a request is
pinned at admission to one rank (``Scheduler``), its blocks come from
that rank's share and its row sits in that rank's rows of every step, so
no KV moves between steps.  The scheduler runs on rank 0's clock,
broadcast over the whole mesh (``ServeState.clock``), so every rank
admits, packs and finishes alike.  The block kinds ``attn``,
``attn_moe``, ``mla`` and ``mla_moe`` serve on a mesh (expert-parallel
MoE, MLA's heads over ``model``, the latent pool's blocks over the FSDP
axes); a MoE's capacity ranking is global over rows split across the
FSDP ranks (``rows=``; ``models/moe.py``).  ``attn_local``, ``mamba``,
``mamba_shared_attn``, ``rwkv`` and the modality families (whisper's
encoder and ``dec_cross`` layers, internvl2's projector) run
``generate`` on a mesh (their heads over ``model``; a sliding window's
ring split over ``data`` at batch 1, and whisper's cross keys and
values their frames; a recurrent state whole on every ``data`` rank);
the pool refuses them as meshless.  ``registry=`` on a mesh gives every
rank's registry the meshless values: the step functions' per-layer
``LayerObs`` are reduced over the mesh once a step
(``core/plan.py::MeshObs``), and the scheduler, which every rank runs
alike, counts each request once.  Not yet ported on a mesh, and
refused: selection methods other than ``full`` and ``quoka``, and on a
data axis a preempting scheduling policy.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.selection import METHODS
from repro_torch.models.model import Model, resolve_device
from repro_torch.obs import registry as obs_reg
from repro_torch.serving import pool as pl
from repro_torch.serving.policy import resolve_policy
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.serving.scheduler import Scheduler
from repro_torch.sharding import comm, specs
from repro_torch.sharding import ctx as shctx
from repro_torch.training import checkpoint as ckpt


@dataclass
class GenerationResult:
    tokens: np.ndarray            # (b, max_new)
    ttft_s: float                 # time to first token (prefill + 1 sample)
    decode_tps: float             # decoded tokens/s across the batch
    prompt_len: int               # true prompt length (left pad excluded)
    method: str
    device: str


@dataclass
class ServeState:
    """Mutable state of one continuous-batching run (pool + scheduler +
    step functions + sampling generator + counters)."""
    pool: pl.PagedKVCache
    sched: Scheduler
    fns: Tuple
    generator: torch.Generator
    chunk: int
    max_nb: int
    b_prefill: int
    b_decode: int
    t0: float = field(default_factory=time.perf_counter)
    steps: int = 0
    prefill_steps: int = 0
    decode_steps: int = 0
    occupancy: List[float] = field(default_factory=list)
    #: (rid, token) pairs emitted by the LAST step() — the streaming feed
    events: List[Tuple[int, int]] = field(default_factory=list)
    prefetch_depth: int = 0              # host blocks staged per step
    #: decayed selection counts per logical block, the prefetch ranking
    #: (None: no host tier)
    hot: Optional[np.ndarray] = None
    host_ctr: Tuple = (0, 0, 0, 0)       # last pool tier counters seen
    #: on a mesh, maps this rank's elapsed time to rank 0's (None: own)
    clock: Optional[Callable[[float], float]] = None

    @property
    def now(self) -> float:
        t = time.perf_counter() - self.t0
        return t if self.clock is None else self.clock(t)


@dataclass
class ServeResult:
    """Outcome of one continuous-batching trace."""
    tokens: Dict[int, np.ndarray]        # rid -> (n_generated,) int32
    ttft_s: Dict[int, float]             # rid -> time to first token
    latency_s: Dict[int, float]          # rid -> arrival -> completion
    wall_s: float
    generated: int                       # total tokens across requests
    tokens_per_s: float                  # generated / wall_s
    steps: int = 0
    prefill_steps: int = 0
    decode_steps: int = 0
    occupancy: float = 0.0               # mean decode-batch fill [0, 1]
    method: str = ""
    device: str = ""
    cached_len: Dict[int, int] = field(default_factory=dict)  # rid -> hit
    prefix: Dict[str, float] = field(default_factory=dict)    # cache stats
    policy: str = ""                     # scheduling policy name
    preemptions: int = 0                 # suspends during this trace
    resumes: int = 0                     # re-admissions of suspended requests
    deadline_misses: int = 0             # TTFT deadlines blown this trace


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    def __init__(self, model: Model, *, method: Optional[str] = None,
                 sampler: SamplerConfig = SamplerConfig(), device=None,
                 mesh=None, registry=None):
        """Serves ``model`` on ``device`` — the CUDA card unless the caller
        passes another; the model must already live there.  ``registry``
        (``obs.Registry``) turns on serve-path telemetry; ``mesh`` serves
        tensor-parallel and shards the model (module docstring)."""
        dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"model is on {model.device}, engine on {dev}")
        self.method = method or model.cfg.quoka.method
        if self.method not in METHODS:
            raise ValueError(f"unknown selection method {self.method!r}")
        if mesh is not None:
            if self.method not in ("full", "quoka"):
                raise NotImplementedError(
                    f"selection method {self.method!r} on a mesh is not "
                    f"yet ported (full and quoka are)")
            ckpt.shard(model, mesh)
        self.mesh = mesh
        self.model = model
        self.device = dev
        self.sampler = sampler
        self.registry = registry if registry is not None else obs_reg.NULL
        self._obs_on = bool(self.registry.enabled)
        self.stats: Dict[str, float] = {}   # prefix-cache stats of last serve
        self._warmed: set = set()           # warmed generate/serve geometries

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
        ``pad_prompt``; its "pad" entry rides along).  The modality inputs
        ride along too: whisper's ``frames`` (b, n_ctx, d) and a VLM's
        ``patches`` (b, n, d_in), whose n positions come before the
        prompt's (the cache holds them, and decode starts at n + T)."""
        with self._policy():
            return self._generate(batch, max_new, generator)

    def _policy(self):
        """The mesh policy for the duration of a call (nothing meshless)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return shctx.policy(self.mesh, tuple(
            a for a in ("pod", "data") if a in specs.mesh_shape(self.mesh)))

    def _layout(self, b: int, cap: int):
        """(this rank's rows of a (b, cap) ``generate``, the axis its
        caches' sequence splits over or None), as ``specs.batch_spec`` and
        ``cache_specs`` place them: rows over the FSDP axes when they
        divide b; else every row, and the sequence of each KV or latent
        cache over ``data`` where it divides that cache's capacity (a
        recurrent state has no sequence: every ``data`` rank holds it
        whole and runs the whole scan; whisper's cross-attention keys
        and values split their encoder frames as a KV cache its slots).
        Meshless: every row, no split."""
        fax = self.model.fsdp
        if fax is None:
            return slice(0, b), None
        cfg, mesh = self.model.cfg, self.mesh
        if specs.batch_spec(cfg, {"tokens": (b, 1)}, mesh)["tokens"][0]:
            n = b // fax.size
            return slice(fax.rank * n, (fax.rank + 1) * n), None
        place = specs.cache_specs(cfg, specs.kv_cache_shapes(cfg, b, cap),
                                  mesh)
        if any(p[2] == "data" for k, p in place.items()
               if k.endswith(("/kv/k", "/latent/ckv", "/cross/k"))):
            return slice(0, b), comm.axis(mesh, "data")
        return slice(0, b), None

    def _generate(self, batch: Dict, max_new: int,
                  generator: Optional[torch.Generator]) -> GenerationResult:
        model, dev = self.model, self.device
        tokens = np.asarray(batch["tokens"])
        b, t = tokens.shape
        positions = t + model.cfg.prefix_positions
        cap = positions + max_new
        g = model.cfg.quoka.granularity
        if self.method != "full" and g > 1:
            cap = -(-cap // g) * g     # block plans need the cache on the grid
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        rows, seq = self._layout(b, cap)
        # a MoE's capacity counts every rank's rows when they are split
        rax = model.fsdp if rows != slice(0, b) else None
        if rows != slice(0, b):
            batch = {k: (v if v is None else np.asarray(v)[rows])
                     for k, v in batch.items()}
        nb = rows.stop - rows.start

        # first call on a signature: build the kernels and warm every path
        # on a throwaway cache, off the clocks
        sig = (b, t, cap, max_new > 1,
               tuple(sorted(k for k in batch if batch[k] is not None)))
        if sig not in self._warmed:
            wgen = torch.Generator(device=dev)
            wcache = model.init_cache(nb, cap, seq)
            wl, wcache = model.prefill(batch, wcache, self.method, rax)
            wt = sample(wl[:b], wgen, self.sampler)
            if max_new > 1:
                wl, wcache = model.decode_step(wt[rows], positions, wcache,
                                               self.method, rows=rax)
                sample(wl[:b], wgen, self.sampler)
            _sync(dev)
            del wcache
            self._warmed.add(sig)

        # under FSDP the logits cover every FSDP rank's rows: the whole
        # batch (rows split) or a copy per rank (``[:b]`` takes rank 0's)
        cache = model.init_cache(nb, cap, seq)
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(batch, cache, self.method, rax)
        tok = sample(logits[:b], generator, self.sampler)
        _sync(dev)
        ttft = time.perf_counter() - t0

        out = [tok]
        t1 = time.perf_counter()
        pos = positions
        for _ in range(max_new - 1):
            logits, cache = model.decode_step(tok[rows], pos, cache,
                                              self.method, rows=rax)
            tok = sample(logits[:b], generator, self.sampler)
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

    # ------------------------------------------------------------------
    # continuous batching
    # ------------------------------------------------------------------
    def _continuous_fns(self, block_size: int, max_nb: int,
                        pool: pl.PagedKVCache, sel_on: bool = False):
        """The two step functions for one geometry: gather blocks -> model
        step -> sample -> scatter the touched blocks back.  Host arrays
        (tables, starts, lengths) stay on the host for the index decisions
        of gather/scatter; the model gets the per-row starts as device
        tensors.  Each returns the sampled tokens (rows,) or, with
        ``sel_on`` (host tier), (rows, 1 + max_nb) int64: the tokens, then
        the plans' selection counts per logical block (the prefetch
        oracle), stacked so one copy brings both to the host; called with
        ``with_obs=True`` each returns (that, the per-layer ``LayerObs``).
        ``during`` (the prefetch hook) runs once the gather is queued and
        the step's inputs are on the device, before the model: an eager
        step is dispatched kernel by kernel, so copies started there run
        under this step's compute (started after the whole step, they
        would find the card idle), and no copy from pageable memory —
        which would wait behind them on the copy engine, and hold the host
        there — comes until the scatter."""
        model, method, sampler = self.model, self.method, self.sampler
        dev = self.device
        chunk = model.cfg.quoka.chunk_size
        selb = (block_size, max_nb) if sel_on else None
        # the pool's block axis over the FSDP ranks: each runs its rows
        # (``_place``) on its blocks, with local ids (and reads the whole
        # step's logits: ``[:n]`` keeps rank 0's copy when rows repeat)
        dp, n_loc = pool.dp, pool.local_blocks
        rax = model.fsdp if dp > 1 else None     # the rows split over it

        def local(table, *rows):
            if dp == 1:
                return (table,) + rows
            n = table.shape[0] // dp
            sl = slice(pool.rank * n, (pool.rank + 1) * n)
            t = table[sl]
            t = np.where(t >= 0, t - pool.base, -1).astype(np.int32)
            if t.max(initial=-1) >= n_loc:
                raise RuntimeError("a step row names another rank's block")
            return (t,) + tuple(np.asarray(r)[sl] for r in rows)

        def out(tok, res, with_obs):
            # res: (head, cache[, obs][, sel])
            o = tok if not sel_on else \
                torch.cat([tok[:, None], res[-1].long()], dim=1)
            return (o, res[2]) if with_obs else o

        @torch.no_grad()
        def prefill_step(data, table, tokens, start, vlen, generator,
                         during=None, with_obs=False):
            n = table.shape[0]
            table, tokens, start, vlen = local(table, tokens, start, vlen)
            cache = pl.gather(data, table, n_loc, block_size)
            inputs = [torch.as_tensor(x, device=dev)
                      for x in (tokens, start, vlen)]
            if during is not None:
                during()
            res = model.prefill_chunk(
                {"tokens": inputs[0]}, inputs[1], cache, method,
                valid_len=inputs[2], with_obs=with_obs, sel_blocks=selb,
                rows=rax)
            logits = model._readout(res[0][:, None, :])[:n, 0]
            tok = sample(logits, generator, sampler)
            # the whole chunk is written (pos -1 past valid_len), so a row
            # with any valid token touches all of its chunk's blocks
            wrote = np.where(vlen > 0, chunk, 0)
            touched = pl.touched_blocks(start, wrote, max_nb, block_size)
            pl.scatter(data, res[1], table, touched, n_loc, block_size)
            return out(tok, res, with_obs)

        @torch.no_grad()
        def decode_step(data, table, tokens, pos, live, generator,
                        during=None, with_obs=False):
            n = table.shape[0]
            table, tokens, pos, live = local(table, tokens, pos, live)
            cache = pl.gather(data, table, n_loc, block_size)
            inputs = [torch.as_tensor(x, device=dev) for x in (tokens, pos)]
            if during is not None:
                during()
            res = model.decode_step(inputs[0].long(), inputs[1], cache,
                                    method, with_obs=with_obs,
                                    sel_blocks=selb, rows=rax)
            tok = sample(res[0][:n], generator, sampler)
            touched = pl.touched_blocks(pos, live, max_nb, block_size)
            pl.scatter(data, res[1], table, touched, n_loc, block_size)
            return out(tok, res, with_obs)

        return prefill_step, decode_step

    def prefix_align(self) -> int:
        """Prefix-cache hit granularity: selection methods score per chunk,
        so hits must land on the B_CP grid to replay the exact computation;
        dense attention is chunking-invariant and shares at token
        granularity (COW partial tails)."""
        chunk = self.model.cfg.quoka.chunk_size
        return 1 if self.method == "full" else chunk

    def make_serve_state(self, requests: Sequence, *,
                         block_size: Optional[int] = None,
                         num_blocks: Optional[int] = None,
                         max_prefill_tokens: Optional[int] = None,
                         max_decode_batch: int = 8,
                         generator: Optional[torch.Generator] = None,
                         prefix_cache: bool = True,
                         host_tier_blocks: Optional[int] = None,
                         prefetch_depth: Optional[int] = None,
                         policy=None,
                         max_prefill_rows: Optional[int] = None
                         ) -> ServeState:
        """Size the pool and scheduler for a request trace and fix the step
        geometry (chunk width, prefill rows, decode rows, blocks per
        request).  The first state of a geometry builds the kernels and
        runs both step functions once on idle rows (all table entries -1,
        so nothing reaches the pool), off every clock.

        ``policy`` (None | "fcfs" | "slo" | SchedPolicy) selects the
        scheduling policy (serving/policy.py); a preempting policy widens
        the per-request block geometry to the suspend/resume worst case.
        ``max_prefill_rows`` overrides the prefill-row count (default: the
        full-chunk capacity ``max_prefill_tokens // chunk``).

        ``host_tier_blocks`` > 0 (default 0) turns on the hierarchical
        pool (demoted prefix blocks stay matchable in host memory;
        serving/pool.py) and the step functions' selection-count output;
        ``prefetch_depth`` (default 4) caps the host blocks the prefetch
        hook stages per step."""
        htb = int(host_tier_blocks or 0)
        pfd = 4 if prefetch_depth is None else int(prefetch_depth)
        chunk = self.model.cfg.quoka.chunk_size
        block_size = block_size or chunk
        g = self.model.cfg.quoka.granularity
        if self.method != "full" and g > 1 and block_size % g != 0:
            raise ValueError(
                f"block_size={block_size} must be a multiple of the "
                f"selection granularity {g}: block-granular plans name "
                f"whole sub-blocks of the paged pool")
        max_prefill_tokens = max_prefill_tokens or 4 * chunk
        pol = resolve_policy(policy)
        align = self.prefix_align() if prefix_cache else chunk
        max_nb = max(pl.max_blocks_bound(r.prompt_len, r.max_new, chunk,
                                         block_size, align=align,
                                         preempt=pol.may_preempt)
                     for r in requests)
        if num_blocks is None:
            num_blocks = max_decode_batch * max_nb    # no contention
        b_p = (max(1, max_prefill_tokens // chunk)
               if max_prefill_rows is None else max(1, int(max_prefill_rows)))
        rows = b_p                  # the scheduler's cap (pre rounding)
        b_d = max_decode_batch
        clock = None
        if self.mesh is not None:
            # the pool's block axis follows the data axes: round the pool
            # and the step rows up to the data-parallel degree, as the
            # reference does; each rank then admits up to its share of
            # the rows (``Scheduler``), within the global
            # ``max_decode_batch``
            dp = specs._axes_size(self.mesh, specs.fsdp_axes(self.mesh))
            if dp > 1 and pol.may_preempt:
                raise NotImplementedError(
                    f"a preempting scheduling policy ({pol.name}) on a data "
                    f"axis is not yet ported")
            num_blocks = -(-num_blocks // dp) * dp
            b_p = -(-b_p // dp) * dp
            b_d = -(-b_d // dp) * dp
            ax = comm.world(self.mesh)
            clock = lambda t: comm.broadcast_float(t, ax, self.device)
        pool = pl.PagedKVCache(self.model, num_blocks, block_size,
                               mesh=self.mesh, host_tier_blocks=htb)
        # selection methods consume prefill in ``granularity``-sized score
        # units — that is the finest grid a packed chunk can be charged at
        grid = 1 if self.method == "full" else max(1, g)
        sched = Scheduler(pool, chunk, max_prefill_tokens, max_decode_batch,
                          prefix_cache=prefix_cache, prefix_align=align,
                          registry=self.registry, policy=pol,
                          max_prefill_rows=rows, token_grid=grid)
        fns = self._continuous_fns(block_size, max_nb, pool,
                                   sel_on=htb > 0)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        state = ServeState(pool=pool, sched=sched, fns=fns,
                           generator=generator, chunk=chunk, max_nb=max_nb,
                           b_prefill=b_p, b_decode=b_d, prefetch_depth=pfd,
                           hot=np.zeros((max_nb,), np.float64) if htb
                           else None, clock=clock)
        sig = ("serve", block_size, max_nb, b_p, b_d, num_blocks, htb > 0)
        if sig not in self._warmed:
            with self._policy():
                self._warm_steps(state)
            self._warmed.add(sig)
        return state

    def _warm_steps(self, state: ServeState) -> None:
        """Both step functions once on idle rows: tables all -1 and no
        valid token, so every write is masked out of the pool."""
        pool = state.pool
        wgen = torch.Generator(device=self.device)
        idle_p = np.full((state.b_prefill, state.max_nb), -1, np.int32)
        zeros_p = np.zeros((state.b_prefill,), np.int32)
        state.fns[0](pool.data, idle_p,
                     np.zeros((state.b_prefill, state.chunk), np.int32),
                     zeros_p, zeros_p, wgen)
        idle_d = np.full((state.b_decode, state.max_nb), -1, np.int32)
        zeros_d = np.zeros((state.b_decode,), np.int32)
        state.fns[1](pool.data, idle_d, zeros_d, zeros_d, zeros_d, wgen)
        _sync(self.device)

    @staticmethod
    def _fetch(out: torch.Tensor) -> np.ndarray:
        """The step's one device-to-host copy (and so its one sync)."""
        return out.cpu().numpy()

    def _note_hot(self, state: ServeState, res: np.ndarray,
                  rows: int) -> np.ndarray:
        """Split a step's fetched output into its tokens and, with the host
        tier on, fold its selection counts ((rows, max_nb) after the token
        column) into the decayed per-logical-block hotness the prefetch
        ranks by: the decay keeps the ranking on the current working set's
        selection pattern."""
        if state.hot is None:
            return res
        state.hot = 0.5 * state.hot + res[:rows, 1:].astype(
            np.float64).sum(axis=0)
        return res[:, 0]

    def _prefetch(self, state: ServeState) -> int:
        """Stage upcoming promotions' H2D copies while a step is being
        dispatched (the step functions call this once their gather is
        queued; the step's copy to the host comes after): the next waiting
        request's host-tier matches, ranked by the decayed QUOKA selection
        counts of their LOGICAL block offsets (blocks the scoring keeps
        selecting move first), at most ``prefetch_depth`` new copies per
        step.  An ordering hint only: a promotion copies whatever was not
        staged at admission.  Returns the copies started.

        Unlike the reference, which takes the ``prefetch_depth`` hottest
        candidates and re-stages them idempotently (so a step after the
        first stages nothing new), already staged slots are skipped: each
        step moves up to ``prefetch_depth`` blocks the request still
        needs.  Tokens do not depend on it."""
        pool, sched = state.pool, state.sched
        if pool.host is None or state.prefetch_depth <= 0 \
                or not sched.waiting:
            return 0
        r = sched.waiting[0]
        chain = sched._chain.get(r.rid)
        if chain is None:           # hashed once while the request waits
            chain = sched._chain[r.rid] = pl._chain_hashes(r.tokens,
                                                            pool.block_size)
        fulls, tail = pool.match_prefix(r.tokens, chain=chain)
        cand = [(li, e[1]) for li, e in enumerate(fulls)
                if isinstance(e, tuple)]
        if tail is not None and isinstance(tail[0], tuple):
            cand.append((len(fulls), tail[0][1]))
        cand = [c for c in cand if c[1] not in pool._staged]
        hot = state.hot
        cand.sort(key=lambda c: -(hot[c[0]] if c[0] < hot.shape[0]
                                  else 0.0))
        slots = [slot for _, slot in cand[:state.prefetch_depth]]
        with self.registry.span("pool/h2d_stage", blocks=len(slots)), \
                torch.profiler.record_function("pool_h2d_stage"):
            n = pool.stage(*slots)
        if n:
            self.registry.count("pool/staged", float(n))
        return n

    def _host_counters(self, state: ServeState) -> None:
        """Registry counters for this step's tier traffic (deltas of the
        pool's monotonic totals)."""
        pool = state.pool
        cur = (pool.demoted, pool.promoted, pool.host_evictions,
               pool.staged_used)
        for name, now_v, prev in zip(
                ("pool/demoted", "pool/promoted", "pool/host_evictions",
                 "pool/staged_used"), cur, state.host_ctr):
            if now_v > prev:
                self.registry.count(name, float(now_v - prev))
        state.host_ctr = cur

    def _record_layer_obs(self, phase: str, lobs) -> None:
        """Feed one step's per-layer ``LayerObs`` into the registry: the
        selected-KV fraction per layer beside the budget ratio, plan
        refresh / reuse counts, and the score sketch.  NaN marks not
        applicable (non-selecting layers; budget and sketch of a dense
        layer; the sketch of a reusing layer) and is skipped.  One stacked
        device-to-host copy, whose (7, n_layers) rows, in ``LayerObs``
        field order, go to ``_note_layer_obs``."""
        self._note_layer_obs(phase, torch.stack(list(lobs)).cpu().numpy())

    def _note_layer_obs(self, phase: str, rows) -> None:
        reg = self.registry
        sel, ctx, bud, ref, lo, mean, hi = rows
        with np.errstate(invalid="ignore", divide="ignore"):
            frac = sel / ctx
            budf = bud / ctx
        for li in range(sel.shape[0]):
            if not np.isfinite(frac[li]):
                continue
            reg.set(f"select/layer{li:02d}/kv_fraction", frac[li])
            reg.observe("select/kv_fraction", frac[li])
            reg.observe(f"select/{phase}/kv_fraction", frac[li])
            if np.isfinite(budf[li]):
                reg.set(f"select/layer{li:02d}/budget_fraction", budf[li])
        fin = ref[np.isfinite(ref)]
        if fin.size:
            n_ref = float(fin.sum())
            reg.count("select/plan_refresh", n_ref)
            reg.count("select/plan_reuse", float(fin.size) - n_ref)
        for nm, v in (("score_lo", lo), ("score_mean", mean),
                      ("score_hi", hi)):
            v = v[np.isfinite(v)]
            if v.size:
                reg.observe(f"select/{nm}", float(v.mean()))

    def step(self, state: ServeState) -> Tuple[int, int]:
        """One engine step: admit, run a mixed chunk-prefill step over up to
        ``max_prefill_tokens`` of pending prompt chunks, then a batched
        decode step over every active decode request.  Returns
        (prefill rows, decode rows) executed.  ``state.events`` is reset and
        filled with this step's emitted (rid, token) pairs — the feed
        ``serve_stream`` yields from."""
        with self._policy():
            return self._step(state)

    def _step(self, state: ServeState) -> Tuple[int, int]:
        pool, sched = state.pool, state.sched
        reg, obs = self.registry, self._obs_on
        state.events = []
        admitted = sched.admit(state.now)
        if obs:
            now = state.now
            for r in admitted:
                reg.observe("sched/admission_wait_s",
                            max(0.0, now - r.arrival_s))
            reg.set("sched/queue_depth", float(len(sched.waiting)))
            reg.set("sched/suspended", float(len(sched.suspended)))
            reg.set("sched/active", float(sched.n_active))
            reg.set("pool/occupancy", 1.0 - pool.num_free / pool.num_blocks)
            reg.set("pool/cached_blocks", float(pool.num_cached))
            if pool.host is not None:
                reg.set("pool/host_blocks", float(len(pool.host)))
                self._host_counters(state)
        kw = {"with_obs": True} if obs else {}

        rows = sched.pack_prefill(state.now)
        if rows:
            tokens = np.zeros((state.b_prefill, state.chunk), np.int32)
            start = np.zeros((state.b_prefill,), np.int32)
            vlen = np.zeros((state.b_prefill,), np.int32)
            at = self._place(pool, [r for r, *_ in rows], state.b_prefill)
            for i, (r, ch, st, vl) in zip(at, rows):
                tokens[i], start[i], vlen[i] = ch, st, vl
            table = pool.table_array([r.rid for r, *_ in rows],
                                     state.b_prefill, state.max_nb, at=at)
            # host-tier blocks are staged while the step is dispatched,
            # then comes the step's one sync; the span brackets the step
            # through that token fetch
            with reg.span("engine/prefill_step", rows=len(rows)):
                out = state.fns[0](pool.data, table, tokens, start, vlen,
                                   state.generator,
                                   during=lambda: self._prefetch(state),
                                   **kw)
                out, lobs = out if obs else (out, None)
                tok_np = self._note_hot(state, self._fetch(out), len(rows))
            if obs:
                self._record_layer_obs("prefill", lobs)
                reg.count("engine/prefill_tokens", float(vlen.sum()))
            now = state.now
            for i, (r, ch, st, vl) in zip(at, rows):
                ev = sched.note_prefilled(r, vl, int(tok_np[i]), now)
                if ev is not None:
                    state.events.append((r.rid, ev))
            state.prefill_steps += 1

        drows = sched.pack_decode()
        if drows:
            tokens = np.zeros((state.b_decode,), np.int32)
            pos = np.zeros((state.b_decode,), np.int32)
            live = np.zeros((state.b_decode,), np.int32)
            at = self._place(pool, drows, state.b_decode)
            for i, r in zip(at, drows):
                tokens[i], pos[i], live[i] = r.out[-1], r.decode_pos, 1
            table = pool.table_array([r.rid for r in drows],
                                     state.b_decode, state.max_nb, at=at)
            with reg.span("engine/decode_step", rows=len(drows)):
                out = state.fns[1](pool.data, table, tokens, pos, live,
                                   state.generator,
                                   during=lambda: self._prefetch(state),
                                   **kw)
                out, lobs = out if obs else (out, None)
                tok_np = self._note_hot(state, self._fetch(out), len(drows))
            if obs:
                self._record_layer_obs("decode", lobs)
                reg.count("engine/decode_tokens", float(len(drows)))
            now = state.now
            for i, r in zip(at, drows):
                state.events.append((r.rid,
                                     sched.note_decoded(r, int(tok_np[i]),
                                                        now)))
            state.occupancy.append(len(drows) / sched.max_decode_batch)
            state.decode_steps += 1

        state.steps += 1
        return len(rows), len(drows)

    @staticmethod
    def _place(pool, reqs, n_rows: int) -> List[int]:
        """The step row of each request: in order, or, when the pool's
        blocks are split over the FSDP ranks, the next free row among its
        rank's ``n_rows / dp`` (its blocks live only there)."""
        if pool.dp == 1:
            return list(range(len(reqs)))
        per = n_rows // pool.dp
        used = [0] * pool.dp
        at = []
        for r in reqs:
            k = pool.rank_of_rid(r.rid)
            if used[k] == per:
                raise RuntimeError(f"rank {k} has more than {per} rows")
            at.append(k * per + used[k])
            used[k] += 1
        return at

    def serve_stream(self, requests: Sequence, *,
                     block_size: Optional[int] = None,
                     num_blocks: Optional[int] = None,
                     max_prefill_tokens: Optional[int] = None,
                     max_decode_batch: Optional[int] = None,
                     generator: Optional[torch.Generator] = None,
                     prefix_cache: Optional[bool] = None,
                     host_tier_blocks: Optional[int] = None,
                     prefetch_depth: Optional[int] = None,
                     policy=None, max_prefill_rows: Optional[int] = None,
                     state: Optional[ServeState] = None):
        """Streaming front-end of ``serve``: a generator yielding
        ``(rid, token)`` the step each token is emitted (the first token of
        a request right after its prefill completes, then one per decode
        step).  The generator's return value is the full ``ServeResult`` —
        ``serve()`` is exactly a drain of this stream.  The idle wait until
        the next arrival is recomputed from the current clock each time and
        capped at 0.25 s."""
        requests = list(requests)
        if not requests:
            return ServeResult({}, {}, {}, 0.0, 0, 0.0, method=self.method,
                               device=str(self.device))
        if state is None:
            state = self.make_serve_state(
                requests, block_size=block_size, num_blocks=num_blocks,
                max_prefill_tokens=max_prefill_tokens,
                max_decode_batch=(8 if max_decode_batch is None
                                  else max_decode_batch),
                generator=generator,
                prefix_cache=(True if prefix_cache is None
                              else prefix_cache),
                host_tier_blocks=host_tier_blocks,
                prefetch_depth=prefetch_depth, policy=policy,
                max_prefill_rows=max_prefill_rows)
        elif (block_size is not None or num_blocks is not None
              or max_prefill_tokens is not None or generator is not None
              or max_decode_batch is not None or prefix_cache is not None
              or host_tier_blocks is not None or prefetch_depth is not None
              or policy is not None or max_prefill_rows is not None):
            # silently ignoring these would e.g. report cache-on numbers
            # for a prefix_cache=False A/B pass over a warm state
            raise ValueError(
                "serve(state=...) reuses the state's geometry, cache "
                "configuration and policy; pass these options to "
                "make_serve_state instead")
        sched = state.sched
        if sched.pending():
            raise RuntimeError("serve state is mid-trace; drain it first")
        need = max(pl.max_blocks_bound(r.prompt_len, r.max_new, state.chunk,
                                       state.pool.block_size,
                                       align=sched.prefix_align,
                                       preempt=sched.policy.may_preempt)
                   for r in requests)
        if need > state.max_nb:
            raise ValueError(
                f"trace needs {need} blocks/request > state geometry "
                f"{state.max_nb}; build a fresh state")
        if len({r.rid for r in requests}) != len(requests):
            raise ValueError("duplicate request ids in one trace")
        sched.done = []                     # per-trace completion list
        state.steps = state.prefill_steps = state.decode_steps = 0
        state.occupancy = []
        state.events = []
        pool = state.pool
        prefix0 = (pool.lookups, pool.hit_requests, pool.hit_tokens,
                   pool.prompt_tokens, pool.evictions, pool.cow_copies,
                   pool.demoted, pool.promoted, pool.host_evictions,
                   pool.staged_used)
        sched0 = (sched.preemptions, sched.resumes, sched.deadline_misses)
        pending = sorted(requests, key=lambda r: r.arrival_s)
        state.t0 = time.perf_counter()
        while pending or sched.pending():
            now = state.now
            while pending and pending[0].arrival_s <= now:
                sched.add(pending.pop(0))
            if not sched.pending():
                time.sleep(min(0.25, max(0.0, pending[0].arrival_s - now)))
                continue
            n_pf, n_dec = self.step(state)
            if n_pf == 0 and n_dec == 0 and sched.pending():
                raise RuntimeError(
                    "scheduler stall: pending requests but nothing packed")
            for ev in state.events:
                yield ev

        wall = state.now
        pool.check_invariants()
        assert pool.num_free + pool.num_evictable == pool.num_blocks, \
            "blocks leaked after drain"
        done = sched.done
        generated = sum(len(r.out) for r in done)
        hit_tok = pool.hit_tokens - prefix0[2]
        all_tok = pool.prompt_tokens - prefix0[3]
        # ``Engine.stats`` / ``ServeResult.prefix`` are registry views:
        # this trace's prefix-cache stats land in gauges under
        # serve/prefix/ (gauges: they are this trace's deltas, which
        # counters would add up across serves) and come back as a flat
        # suffix-keyed dict; with metrics off an ephemeral registry keeps
        # the same dict
        preg = self.registry if self._obs_on else obs_reg.Registry()
        sc = preg.scope("serve/prefix")
        sc.set("requests", pool.lookups - prefix0[0])
        sc.set("cache_hits", pool.hit_requests - prefix0[1])
        sc.set("hit_tokens", hit_tok)
        sc.set("prompt_tokens", all_tok)
        sc.set("hit_rate", hit_tok / all_tok if all_tok else 0.0)
        sc.set("evictions", pool.evictions - prefix0[4])
        sc.set("cow_copies", pool.cow_copies - prefix0[5])
        sc.set("cached_blocks", pool.num_cached)
        if pool.host is not None:
            sc.set("demoted", pool.demoted - prefix0[6])
            sc.set("promoted", pool.promoted - prefix0[7])
            sc.set("host_evictions", pool.host_evictions - prefix0[8])
            sc.set("staged_used", pool.staged_used - prefix0[9])
            sc.set("host_blocks", len(pool.host))
        self.stats = preg.view("serve/prefix")
        if self._obs_on:
            reg = self.registry
            for r in done:
                if r.ttft_s is not None:
                    reg.observe("serve/ttft_s", r.ttft_s)
                    reg.observe(f"tenant/{r.tenant}/ttft_s", r.ttft_s)
                dec = len(r.out) - 1
                if dec > 0 and r.done_s is not None and r.ttft_s is not None:
                    tpot = (r.done_s - r.arrival_s - r.ttft_s) / dec
                    reg.observe("serve/tpot_s", tpot)
                    reg.observe(f"tenant/{r.tenant}/tpot_s", tpot)
            reg.count("serve/requests_finished", float(len(done)))
            reg.count("serve/tokens_generated", float(generated))
            reg.event("serve_done", wall_s=wall, requests=len(done),
                      generated=generated,
                      tokens_per_s=generated / wall if wall > 0 else 0.0,
                      steps=state.steps,
                      prefill_steps=state.prefill_steps,
                      decode_steps=state.decode_steps,
                      method=self.method, device=str(self.device),
                      **{f"prefix_{k}": v for k, v in self.stats.items()})
        return ServeResult(
            tokens={r.rid: np.asarray(r.out, np.int32) for r in done},
            ttft_s={r.rid: r.ttft_s for r in done},
            latency_s={r.rid: r.done_s - r.arrival_s for r in done},
            wall_s=wall, generated=generated,
            tokens_per_s=generated / wall if wall > 0 else 0.0,
            steps=state.steps, prefill_steps=state.prefill_steps,
            decode_steps=state.decode_steps,
            occupancy=(float(np.mean(state.occupancy))
                       if state.occupancy else 0.0),
            method=self.method, device=str(self.device),
            cached_len={r.rid: r.cached_len for r in done},
            prefix=dict(self.stats),
            policy=sched.policy.name,
            preemptions=sched.preemptions - sched0[0],
            resumes=sched.resumes - sched0[1],
            deadline_misses=sched.deadline_misses - sched0[2])

    def serve(self, requests: Sequence, **kwargs) -> ServeResult:
        """Serve a request trace with continuous batching (a drain of
        ``serve_stream``; same keyword options).

        ``requests``: serving.request.Request objects (``arrival_s`` offsets
        are honoured against the wall clock).  Each engine step packs up to
        ``max_prefill_tokens`` of pending prompt chunks plus every active
        decode token; admission order, prefill packing and preemption follow
        ``policy``.  Greedy outputs under the default policy are
        token-identical to per-request ``generate`` and to the reference's
        ``Engine.serve``, prefix-cache hits included.  Pass a ``state`` from
        ``make_serve_state`` to serve several traces over one warm pool."""
        stream = self.serve_stream(requests, **kwargs)
        while True:
            try:
                next(stream)
            except StopIteration as stop:
                return stop.value
