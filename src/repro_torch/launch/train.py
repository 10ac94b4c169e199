"""Training launcher (counterpart of ``repro/launch/train.py``).

Runs on the CUDA card unless ``--device cpu`` is given; weights are drawn
from seed 0 and the synthetic LM (or needle) stream from the reference's
data seed (``data/synthetic.py::REF_SEED``).  ``--smoke`` trains the
reduced config; otherwise the published widths, with each layer
recomputed in the backward (``remat``), as the reference's launcher sets
it.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --steps 3 --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
        --smoke --steps 3 --batch 2 --seq 64 --device cpu

After the steps it prints the step time (host clock between device
synchronisations, the first step off the clock: it builds cuBLAS state
and the caching allocator's pools), tokens per second, the device's peak
memory and, on the card, the model-FLOP share (6 N tokens / time against
989 TFLOP/s, the H100's dense bf16 peak from ``analysis/roofline.py``,
times the cards a mesh's ranks occupy; N counts every parameter and
tokens the global batch).

Sharded training, one process per rank (``torchrun``): ``--host-mesh
DxM`` trains on a ``(data=D, model=M)`` mesh over the world's ranks
(gloo on the CPU or when the ranks share one card, NCCL with a card per
rank: ``launch/mesh.py::choose_backend``): tensor parallelism over
``model`` as serving places it, FSDP weight shards and the batch's rows
over ``data``, the AdamW moments on their weights' shards
(``training/loop.py``).  ``--multi-pod`` (or 256 ranks and more) builds
the reference's production mesh, ``(pod=2, data=16, model=16)`` (or
``(data=16, model=16)``); with fewer ranks the run is meshless, as the
reference's is below 256 devices.  Only rank 0 prints: the reference's
``step i loss gnorm`` lines every 10 steps, then the report line (its
own step time, its own peak).  ``--save`` gathers every shard and rank 0
writes the meshless run's file.

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --device cpu --smoke --host-mesh 2x2 \
        --steps 3 --batch 2 --seq 64
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import List, NamedTuple, Optional

import torch

from repro_torch.analysis.roofline import PEAK_FLOPS
from repro_torch.configs import get_config
from repro_torch.data.synthetic import REF_SEED, lm_batches, needle_batches
from repro_torch.launch import mesh as lm
from repro_torch.models.model import build_model, resolve_device
from repro_torch.sharding import comm, specs
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import loop as train_loop
from repro_torch.training import optimizer as opt

BF16_PEAK_FLOP_S = PEAK_FLOPS          # H100 SXM, dense bf16 (data sheet)


class TrainRun(NamedTuple):
    state: train_loop.TrainState
    step_s: List[float]            # every step's time, the first included
    losses: List[float]            # every step's loss and gradient norm
    grad_norms: List[float]
    tokens_per_step: int
    n_params: int
    peak_gib: Optional[float]      # the card's peak allocation, else None
    device: str
    cards: int = 1                 # the cards a mesh's ranks occupy

    def mean_step_s(self) -> float:
        """The mean step time with the first step off the clock (the
        only one when there is one)."""
        timed = self.step_s[1:] or self.step_s
        return sum(timed) / len(timed)

    def flop_share(self) -> float:
        """6 N tokens per step over the mean step time, as a share of
        the dense bf16 peak of the H100s the run occupies."""
        return 6 * self.n_params * self.tokens_per_step \
            / self.mean_step_s() / (BF16_PEAK_FLOP_S * self.cards)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data", choices=("lm", "needle"), default="lm")
    ap.add_argument("--host-mesh", default=None,
                    help="DATAxMODEL, e.g. 2x2 (one process per rank under "
                         "torchrun)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (pod=2, data=16, model=16) production mesh "
                         "(512 ranks; meshless below 256)")
    ap.add_argument("--save", default=None, help="checkpoint path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _mesh(args):
    """The run's mesh (``--host-mesh``, or the production mesh at 256
    ranks and more, as the reference's launcher), or None."""
    if args.host_mesh:
        d, m = (int(x) for x in args.host_mesh.split("x"))
        return lm.mesh_from_spec(f"data={d},model={m}", args.device)
    if lm.n_ranks() >= 256:
        return lm.make_production_mesh(multi_pod=args.multi_pod,
                                       device=args.device)
    return None


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    mesh = _mesh(args)
    if mesh is None:
        return _main(args, resolve_device(args.device))
    import torch.distributed as dist
    try:
        # every rank runs the same program; only rank 0 prints
        with (contextlib.nullcontext() if comm.seed(mesh) else
              contextlib.redirect_stdout(open(os.devnull, "w"))):
            print(f"# mesh {specs.mesh_shape(mesh)} over "
                  f"{dist.get_world_size()} ranks "
                  f"({comm.axis(mesh).backend}, {mesh.device_type})")
            return _main(args, resolve_device(args.device), mesh)
    finally:
        dist.destroy_process_group()


def _main(args, device, mesh=None) -> TrainRun:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    cfg = dataclasses.replace(cfg, remat=not args.smoke)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = build_model(cfg, device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    if mesh is not None:
        ckpt.shard(model, mesh)
    ocfg = opt.OptimizerConfig(lr=args.lr,
                               warmup_steps=max(args.steps // 10, 1),
                               total_steps=args.steps)
    gen = (lm_batches(REF_SEED, cfg.vocab, args.batch, args.seq)
           if args.data == "lm" else
           needle_batches(REF_SEED, cfg.vocab, args.batch, args.seq | 1))
    marks = [_sync(device)]
    losses, norms = [], []

    def timed(i, state, metrics):
        marks.append(_sync(device))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))

    state = train_loop.init_state(model, None)
    if mesh is None:
        state, _ = train_loop.train(model, gen, ocfg=ocfg, steps=args.steps,
                                    state=state, callback=timed)
    else:
        step_fn = train_loop.make_train_step(model, ocfg)
        for i in range(args.steps):
            state, metrics = step_fn(state, next(gen))
            timed(i, state, metrics)
            if i % 10 == 0:                      # the reference's lines
                print(f"step {i:5d} loss {losses[-1]:.4f} gnorm "
                      f"{norms[-1]:.3f}")
    step_s = [b - a for a, b in zip(marks, marks[1:])]
    tokens = args.batch * (args.seq if args.data == "lm" else args.seq | 1)
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 \
        if device.type == "cuda" else None
    run = TrainRun(state=state, step_s=step_s, losses=losses,
                   grad_norms=norms, tokens_per_step=tokens,
                   n_params=n_params, peak_gib=peak, device=str(device),
                   cards=1 if mesh is None else _cards(device))
    _report(run, cfg, mesh is not None)
    if args.save:
        ckpt.save(args.save, state.model, {"arch": cfg.name,
                                           "steps": args.steps})
        print("saved", args.save)
    return run


def _cards(device: torch.device) -> int:
    """How many cards the mesh's ranks occupy (ranks sharing one card
    count it once); 0 on the CPU.  Every rank calls it."""
    import socket

    import torch.distributed as dist
    where = [None] * dist.get_world_size()
    dist.all_gather_object(where, (socket.gethostname(), device.index)
                           if device.type == "cuda" else None)
    return len({w for w in where if w is not None})


def _report(run: TrainRun, cfg, mesh: bool = False) -> None:
    step = run.mean_step_s()
    line = (f"{cfg.name}: {run.n_params / 1e9:.3f} B params, "
            f"{run.tokens_per_step} tokens/step, step {step * 1e3:.1f} ms "
            f"(first {run.step_s[0] * 1e3:.1f} ms), "
            f"{run.tokens_per_step / step:.0f} tok/s on {run.device}")
    if run.peak_gib is not None:
        line += (f", peak {run.peak_gib:.2f} GiB"
                 + (" on rank 0" if mesh else "")
                 + f", model-FLOP share {run.flop_share():.4f} of "
                 + (f"{run.cards} x " if run.cards > 1 else "")
                 + "989 TFLOP/s")
    print(line)


if __name__ == "__main__":
    main()
