"""Serving launcher (counterpart of ``repro/launch/serve.py``).

Runs on the CUDA card unless ``--device cpu`` is given.  One-shot batch
mode (TTFT / decode throughput):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --prompt-len 8192 --max-new 32 --method quoka

``--method`` takes every selection method of ``core/selection.py::METHODS``
(QUOKA, the six baselines, ``full``); ``--compare-dense`` also runs
``full`` on the same prompts.  Cross-layer plan reuse and low-rank scoring
are set in the config (``QuokaConfig.reuse_interval`` /
``correction_layers`` / ``score_proj_dim``), as in the reference.

Continuous-batching trace mode (paged KV pool + chunked-prefill/decode
scheduler + cross-request prefix caching):

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --continuous \
        --n-requests 16 --rate 8 --max-decode-batch 8 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --continuous \
        --trace multiturn --turns 4 --turn-gap 0.5 [--no-prefix-cache]
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --continuous \
        --trace multi_tenant --policy slo --ttft-deadline 0.5

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-2-3b \
        --continuous --trace multiturn --num-blocks 64 \
        --host-tier-blocks 128 --prefetch-depth 4

MoE and MLA models serve one-shot and continuous (deepseek-v3-671b's
latent caches live in the paged pool and its host tier like K/V):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --prompt-len 8192 --batch 1 [--continuous]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --smoke --device cpu --prompt-len 96 \
        --continuous --trace multiturn --n-requests 8 --num-blocks 8 \
        --host-tier-blocks 16 --prefetch-depth 4 --max-decode-batch 1

Sliding-window models (gemma3-27b, h2o-danube-3-4b) serve one-shot only:
their ring caches wrap at the window, not at a pool block, so the paged
pool refuses them and ``--continuous`` raises, as in the reference:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch h2o-danube-3-4b --prompt-len 8192 --batch 1

So do the recurrent families, zamba2-7b (Mamba2 layers and one shared
attention block, on whose KV caches QUOKA selects) and rwkv6-1.6b (no KV
cache): their states have no pool layout, so ``--continuous`` raises the
reference's "... unsupported block kinds" error:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --smoke --device cpu --prompt-len 160 --batch 2 --max-new 4

``--arch`` takes every config of ``configs/base.py::get_config`` (qwen3-4b,
granite-3-2b, llama3-2-3b, stablelm-3b, olmoe-1b-7b, deepseek-v3-671b,
gemma3-27b, h2o-danube-3-4b, zamba2-7b, rwkv6-1.6b; deepseek-v3-671b is
671 B parameters at its published depth, so on one card use ``--smoke`` or
a checkpoint of a depth-cut copy) but whisper-small and internvl2-1b: the
launcher feeds token ids only, as the reference's does, and those two
need their frames or patches in the batch (``Engine.generate``).  ``--host-tier-blocks`` puts a
host-memory tier behind the paged pool (pair it with an undersized
``--num-blocks`` to make pressure demote blocks there), and
``--prefetch-depth`` caps the host blocks staged per step.  Weights are
random from a seed unless ``--ckpt`` names a reference npz checkpoint;
latency does not depend on the weights.

Telemetry: ``--metrics`` serves with an ``obs.Registry`` (step spans,
scheduler and pool counters, the per-layer selected-KV fraction) and
prints a digest after the run; ``--trace-dir DIR`` (implies
``--metrics``) also writes the registry's JSONL log, Prometheus text dump
and Chrome/Perfetto span trace there.  In one-shot mode ``--trace-dir``
instead captures a ``torch.profiler`` trace (CPU and, on the card, CUDA
activity) of the measured ``generate`` into
``DIR/oneshot_<method>.trace.json``; its ``record_function`` ranges
(``plan_scores``, ``plan_materialize``, ``ops_*``) label the regions.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --continuous --metrics --trace-dir /tmp/serve_trace

Serving on a mesh: tensor-parallel over its ``model`` axis, data-parallel
with FSDP weights over its ``pod`` / ``data`` axes (``Engine(mesh=)``),
one process per rank under ``torchrun``, one-shot or ``--continuous``
(models of ``attn``, ``attn_moe``, ``mla`` and ``mla_moe`` layers: the
dense ones, olmoe-1b-7b with its experts over ``model`` and
deepseek-v3-671b with MLA's heads over ``model``; one-shot only, the
sliding-window and recurrent models below; ``launch/mesh.py``
picks NCCL when every rank has a card of its own and gloo when they
share one, or on the CPU).  Only rank 0 prints; its first line is ``#
mesh {...} over N devices``:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \
        --device cpu --smoke --mesh data=2,model=2 --prompt-len 64 \
        --batch 2 --max-new 4 [--continuous]
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \
        --device cpu --smoke --arch olmoe-1b-7b --mesh data=2,model=2 \
        --prompt-len 64 --batch 2 --max-new 4 [--continuous]
    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \
        --device cpu --smoke --arch deepseek-v3-671b --mesh model=2 \
        --prompt-len 64 --max-new 4 --continuous

The sliding-window and recurrent models (gemma3-27b, h2o-danube-3-4b,
zamba2-7b, rwkv6-1.6b) run one-shot on a mesh, their heads over
``model`` (the pool refuses their caches, on a mesh or not):

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \
        --device cpu --smoke --arch zamba2-7b --mesh model=2 \
        --prompt-len 96 --batch 2 --max-new 4
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \
        --device cpu --smoke --arch gemma3-27b --mesh data=2,model=2 \
        --prompt-len 96 --batch 1 --max-new 4

``--batch 1`` splits each KV cache's sequence over ``data`` where
``data`` divides its capacity (a sliding window's ring too); a
recurrent state stays whole on every ``data`` rank.  ``--metrics`` /
``--trace-dir`` serve on a mesh with every rank's registry holding the
meshless run's per-layer selected-KV fractions (rank 0 prints and
writes the files).  Whisper-small and internvl2-1b run on a mesh through
``Engine.generate`` (their frames or patches in the batch), not this
launcher.  Still "not yet ported" on a mesh: methods other than
``full`` and ``quoka``, and on a data axis ``--policy slo`` (it
preempts).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.selection import METHODS
from repro_torch.models.model import build_model, resolve_device
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import make_requests
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.training import checkpoint as ckpt


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b",
                    help="qwen3-4b, granite-3-2b, llama3-2-3b, stablelm-3b, "
                         "olmoe-1b-7b, deepseek-v3-671b (one-shot and "
                         "--continuous), gemma3-27b, h2o-danube-3-4b, "
                         "zamba2-7b, rwkv6-1.6b (one-shot; --continuous "
                         "raises)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--method", default="quoka", choices=METHODS)
    ap.add_argument("--budget", type=int, default=None)
    ap.add_argument("--budget-ratio", type=float, default=None,
                    help="B_SA as a fraction of the prompt (paper Table 2)")
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--compare-dense", action="store_true",
                    help="one-shot mode: also run method 'full' on the same "
                         "prompts")
    ap.add_argument("--granularity", type=int, default=None,
                    help="selection granularity in tokens (default: config)")
    ap.add_argument("--fused", action="store_true",
                    help="fused selected attention (needs --granularity > 1)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    # continuous-batching trace mode
    ap.add_argument("--continuous", action="store_true",
                    help="serve a request trace with the paged-pool "
                         "scheduler instead of one synchronous batch")
    ap.add_argument("--n-requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=float("inf"),
                    help="Poisson arrival rate, requests/s (inf = all at 0)")
    ap.add_argument("--trace", default="poisson",
                    choices=("poisson", "shared", "multiturn",
                             "multi_tenant"),
                    help="trace shape: independent prompts, a shared "
                         "system prompt, multi-turn conversations (those "
                         "two exercise the prefix cache), or a background "
                         "tenant's long prompts vs an interactive tenant's "
                         "deadline-carrying short prompts (--policy slo)")
    ap.add_argument("--policy", default="fcfs", choices=("fcfs", "slo"),
                    help="scheduling policy: FCFS head-of-line (default) "
                         "or SLO-aware (EDF admission, per-tenant weighted "
                         "fairness, preemption of running decodes)")
    ap.add_argument("--ttft-deadline", type=float, default=0.5,
                    help="TTFT deadline (s) of the interactive tenant's "
                         "requests (--trace multi_tenant)")
    ap.add_argument("--shared-len", type=int, default=512,
                    help="shared system-prompt tokens (--trace shared)")
    ap.add_argument("--turns", type=int, default=4,
                    help="turns per conversation (--trace multiturn)")
    ap.add_argument("--turn-gap", type=float, default=0.5,
                    help="seconds between a conversation's turns "
                         "(--trace multiturn)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable cross-request KV prefix caching")
    ap.add_argument("--block-size", type=int, default=None,
                    help="KV pool block size (default: chunk_size)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV pool size (default: fits max-decode-batch)")
    ap.add_argument("--host-tier-blocks", type=int, default=None,
                    help="hierarchical pool: host-memory tier capacity in "
                         "blocks (evicted prefix blocks demote there and "
                         "stay matchable; default 0: no tier). "
                         "Pair with an undersized --num-blocks to exercise "
                         "demotion")
    ap.add_argument("--prefetch-depth", type=int, default=None,
                    help="host-tier blocks staged (H2D on a side stream) "
                         "per engine step ahead of promotion, ranked by the "
                         "QUOKA selection-count oracle (default 4)")
    ap.add_argument("--max-prefill-tokens", type=int, default=None,
                    help="prompt tokens packed per engine step "
                         "(default: 4 * chunk_size)")
    ap.add_argument("--max-decode-batch", type=int, default=8)
    ap.add_argument("--metrics", action="store_true",
                    help="serve-path telemetry (obs/): step spans, "
                         "scheduler/pool counters and the per-layer "
                         "selected-KV fraction; prints a digest after the "
                         "run.  Off by default: the metrics-off path runs "
                         "no telemetry")
    ap.add_argument("--trace-dir", default=None,
                    help="export telemetry (implies --metrics) to DIR: "
                         "JSONL event log, Prometheus text dump and a "
                         "Chrome/Perfetto trace of the engine's step spans; "
                         "one-shot mode instead writes a torch.profiler "
                         "trace of the measured run there")
    ap.add_argument("--mesh", default=None, metavar="data=N,model=M",
                    help="serve on a mesh (run one process per rank under "
                         "torchrun; axes from (pod, data, model): tensor "
                         "parallelism over model, FSDP weights and "
                         "data-parallel rows, pool blocks or a batch-1 "
                         "cache's sequence over pod and data)")
    return ap.parse_args(argv)


def _build_trace(vocab, args, rng):
    """(prompts, arrivals, extras) for one of four trace shapes, as the
    reference builds them from the same numpy seed (extras: per-request
    ``make_requests`` kwargs, empty for the single-tenant traces)."""
    if args.trace == "multi_tenant":
        n_bg = max(1, args.n_requests // 4)
        n_int = max(1, args.n_requests - n_bg)
        bg = [rng.integers(3, vocab, (args.prompt_len,)).astype(np.int32)
              for _ in range(n_bg)]
        ilen = max(1, args.prompt_len // 8)
        inter = [rng.integers(3, vocab,
                              (int(rng.integers(max(1, ilen // 2),
                                                ilen + 1)),)).astype(np.int32)
                 for _ in range(n_int)]
        rate = args.rate if not np.isinf(args.rate) else 1000.0
        arrivals = np.concatenate(
            [np.zeros(n_bg), np.cumsum(rng.exponential(1.0 / rate, n_int))])
        extras = dict(
            tenants=["background"] * n_bg + ["interactive"] * n_int,
            priorities=[0] * n_bg + [1] * n_int,
            ttft_deadlines=[None] * n_bg + [args.ttft_deadline] * n_int)
        return bg + inter, arrivals, extras
    if args.trace in ("poisson", "shared"):
        arrivals = (np.zeros(args.n_requests) if np.isinf(args.rate)
                    else np.cumsum(rng.exponential(1.0 / args.rate,
                                                   args.n_requests)))
        if args.trace == "poisson":
            lens = rng.integers(max(1, args.prompt_len // 2),
                                args.prompt_len + 1, args.n_requests)
            prompts = [rng.integers(3, vocab, (int(n),)).astype(np.int32)
                       for n in lens]
        else:
            sys_tok = rng.integers(3, vocab,
                                   (args.shared_len,)).astype(np.int32)
            sfx = max(1, args.prompt_len - args.shared_len)
            prompts = [np.concatenate(
                [sys_tok, rng.integers(3, vocab,
                                       (int(rng.integers(1, sfx + 1)),)
                                       ).astype(np.int32)])
                for _ in range(args.n_requests)]
        return prompts, arrivals, {}
    n_conv = max(1, args.n_requests // args.turns)
    ext = max(1, args.prompt_len // (2 * args.turns))
    prompts, arrivals = [], []
    for c in range(n_conv):
        start = (0.0 if np.isinf(args.rate)
                 else float(rng.exponential(args.turns / args.rate)) * c)
        cur = rng.integers(3, vocab,
                           (args.prompt_len // 2,)).astype(np.int32)
        for t in range(args.turns):
            if t:
                cur = np.concatenate(
                    [cur, rng.integers(3, vocab, (ext,)).astype(np.int32)])
            prompts.append(cur.copy())
            arrivals.append(start + t * args.turn_gap)
    return prompts, np.asarray(arrivals), {}


def _print_telemetry(reg):
    """Human-readable digest of the serve registry (full detail goes to the
    --trace-dir exports)."""
    snap = reg.snapshot()
    h, g = snap["histograms"], snap["gauges"]
    kv = h.get("select/kv_fraction")
    if kv and kv["count"]:
        print(f"{'telemetry':10s} selected-KV fraction mean {kv['mean']:.3f} "
              f"p50 {kv['p50']:.3f} min {kv['min']:.3f} "
              f"over {kv['count']} layer-steps "
              f"({100 * (1 - kv['mean']):.0f}% of KV skipped on average)")
    for nm in ("engine/prefill_step", "engine/decode_step",
               "sched/admission_wait_s"):
        s = h.get(nm)
        if s and s["count"]:
            print(f"{'telemetry':10s} {nm}: p50 {s['p50'] * 1e3:7.1f} ms  "
                  f"p99 {s['p99'] * 1e3:7.1f} ms  n {s['count']}")
    if "pool/occupancy" in g:
        print(f"{'telemetry':10s} pool occupancy {g['pool/occupancy']:.2f}  "
              f"cached blocks {g.get('pool/cached_blocks', 0):.0f}")


def _export_telemetry(reg, trace_dir, prefix):
    from repro_torch.obs import export_all
    paths = export_all(reg, trace_dir, prefix=prefix)
    for kind, p in sorted(paths.items()):
        print(f"{'telemetry':10s} {kind} -> {p}")
    return paths


def run_continuous(model, args, device, mesh=None):
    """Trace-driven continuous batching with prefix caching; a first serve
    of the longest prompt warms the real step geometry off the clocks.
    With ``--metrics`` / ``--trace-dir`` the measured serve runs with a
    fresh registry (the warm-up's samples are dropped)."""
    from repro_torch.obs import Registry
    rng = np.random.default_rng(0)
    prompts, arrivals, extras = _build_trace(model.cfg.vocab, args, rng)
    reg = Registry() if args.metrics or args.trace_dir else None
    eng = Engine(model, method=args.method, device=device,
                 sampler=SamplerConfig(temperature=args.temperature),
                 registry=reg, mesh=mesh)
    kw = dict(block_size=args.block_size, num_blocks=args.num_blocks,
              max_prefill_tokens=args.max_prefill_tokens,
              max_decode_batch=args.max_decode_batch,
              prefix_cache=not args.no_prefix_cache,
              host_tier_blocks=args.host_tier_blocks,
              prefetch_depth=args.prefetch_depth, policy=args.policy)
    longest = max(prompts, key=len)
    eng.serve(make_requests([longest] * 2, args.max_new), **kw)
    if reg is not None:
        # each serve builds its state (and scheduler) from
        # ``eng.registry``, so a fresh one drops the warm-up's samples
        reg = eng.registry = Registry()
    res = eng.serve(make_requests(prompts, args.max_new, arrivals=arrivals,
                                  **extras), **kw)
    ttft = np.asarray(sorted(res.ttft_s.values()))
    print(f"{args.method:10s} {res.generated} tokens / {res.wall_s:.2f} s "
          f"= {res.tokens_per_s:8.1f} tok/s   "
          f"TTFT p50 {np.percentile(ttft, 50) * 1e3:7.1f} ms   "
          f"p99 {np.percentile(ttft, 99) * 1e3:7.1f} ms   "
          f"occupancy {res.occupancy:.2f}   "
          f"steps {res.steps} ({res.prefill_steps} prefill / "
          f"{res.decode_steps} decode)   device {res.device}")
    print(f"{'policy':10s} {res.policy}: {res.preemptions} preemptions, "
          f"{res.resumes} resumes, {res.deadline_misses} deadline misses")
    if extras:
        by_tenant = {}
        for r in make_requests(prompts, args.max_new, arrivals=arrivals,
                               **extras):
            if r.rid in res.ttft_s:
                by_tenant.setdefault(r.tenant, []).append(res.ttft_s[r.rid])
        for t, vals in sorted(by_tenant.items()):
            v = np.asarray(vals)
            print(f"{'tenant':10s} {t}: TTFT p50 "
                  f"{np.percentile(v, 50) * 1e3:7.1f} ms   p99 "
                  f"{np.percentile(v, 99) * 1e3:7.1f} ms   n {len(v)}")
    s = res.prefix
    print(f"{'cache':10s} {s['cache_hits']:.0f}/{s['requests']:.0f} "
          f"requests hit, {s['hit_tokens']:.0f}/{s['prompt_tokens']:.0f} "
          f"prompt tokens served from cache ({100 * s['hit_rate']:.1f}%), "
          f"{s['evictions']:.0f} evictions, "
          f"{s['cow_copies']:.0f} COW copies")
    if "demoted" in s:
        print(f"{'host tier':10s} {s['demoted']:.0f} demoted, "
              f"{s['promoted']:.0f} promoted "
              f"({s['staged_used']:.0f} from prefetch staging), "
              f"{s['host_evictions']:.0f} host evictions, "
              f"{s['host_blocks']:.0f} blocks resident")
    if reg is not None:
        _print_telemetry(reg)
        if args.trace_dir and _writes(mesh):
            _export_telemetry(reg, args.trace_dir, f"serve_{args.method}")
    return res


def _writes(mesh) -> bool:
    """Does this process write the run's files: meshless, or rank 0 of
    the mesh (every rank holds the same registry)."""
    if mesh is None:
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


def main(argv=None):
    args = parse_args(argv)
    if not args.mesh:
        return _main(args, resolve_device(args.device))
    import torch.distributed as dist
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.sharding import comm, specs
    mesh = mesh_from_spec(args.mesh, args.device)
    ax = comm.axis(mesh)
    rank = dist.get_rank()
    try:
        # every rank runs the same program; only rank 0 prints
        with (contextlib.nullcontext() if rank == 0 else
              contextlib.redirect_stdout(open(os.devnull, "w"))):
            shape = specs.mesh_shape(mesh)
            print(f"# mesh {shape} over {dist.get_world_size()} devices "
                  f"({ax.backend}, {mesh.device_type})")
            dev = resolve_device(args.device)
            if dev.type == "cuda":
                dev = torch.device("cuda", torch.cuda.current_device())
            return _main(args, dev, mesh)
    finally:
        dist.destroy_process_group()


def _main(args, device, mesh=None):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke(n_layers=4, d_model=256, n_heads=8, n_kv_heads=2,
                        d_ff=512, vocab=2048)
    q = cfg.quoka
    if args.budget:
        q = dataclasses.replace(q, budget=args.budget)
    if args.budget_ratio:
        q = dataclasses.replace(q, budget_ratio=args.budget_ratio)
    if args.granularity:
        q = dataclasses.replace(q, granularity=args.granularity)
    if args.fused:
        q = dataclasses.replace(q, fused_select_attn=True)
    cfg = dataclasses.replace(cfg, quoka=dataclasses.replace(
        q, chunk_size=min(q.chunk_size, args.prompt_len)))
    model = ckpt.restore(args.ckpt, cfg, device) if args.ckpt else \
        build_model(cfg, device)
    if args.continuous:
        return run_continuous(model, args, device, mesh)
    rng = np.random.default_rng(0)
    toks = rng.integers(3, cfg.vocab,
                        (args.batch, args.prompt_len)).astype(np.int32)
    runs = []
    for m in [args.method] + (["full"] if args.compare_dense else []):
        eng = Engine(model, method=m, device=device,
                     sampler=SamplerConfig(temperature=args.temperature),
                     mesh=mesh)
        if args.trace_dir:
            # warm the signature off the trace, then profile the measured
            # run (the record_function ranges label its regions; on a
            # mesh rank 0's, the others run it unprofiled)
            eng.generate({"tokens": toks}, args.max_new)
            r = _profiled_generate(eng, {"tokens": toks}, args.max_new,
                                   args.trace_dir, m) if _writes(mesh) \
                else eng.generate({"tokens": toks}, args.max_new)
        else:
            r = eng.generate({"tokens": toks}, args.max_new)
        print(f"{m:18s} TTFT {r.ttft_s * 1e3:9.1f} ms   "
              f"decode {r.decode_tps:8.1f} tok/s   "
              f"prompt {args.prompt_len} x {args.batch}   device {r.device}")
        runs.append(r)
    return runs[0]                       # the run of ``--method``


def _profiled_generate(eng, batch, max_new, trace_dir, method):
    """``eng.generate`` under ``torch.profiler`` (CPU activity, and CUDA on
    the card); the Chrome trace goes to ``trace_dir``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if eng.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        r = eng.generate(batch, max_new)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"oneshot_{method}.trace.json")
    prof.export_chrome_trace(path)
    print(f"# torch profiler trace -> {path}")
    return r


if __name__ == "__main__":
    main()
