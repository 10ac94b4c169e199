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
989 TFLOP/s, the H100's dense bf16 peak from ``analysis/roofline.py``; N
counts every parameter).  Not ported yet: ``--host-mesh`` and
``--multi-pod`` (sharded training).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, NamedTuple, Optional

import torch

from repro_torch.analysis.roofline import PEAK_FLOPS
from repro_torch.configs import get_config
from repro_torch.data.synthetic import REF_SEED, lm_batches, needle_batches
from repro_torch.models.model import build_model, resolve_device
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

    def mean_step_s(self) -> float:
        """The mean step time with the first step off the clock (the
        only one when there is one)."""
        timed = self.step_s[1:] or self.step_s
        return sum(timed) / len(timed)

    def flop_share(self) -> float:
        """6 N tokens per step over the mean step time, as a share of
        the H100's dense bf16 peak."""
        return 6 * self.n_params * self.tokens_per_step \
            / self.mean_step_s() / BF16_PEAK_FLOP_S


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
                    help="DATAxMODEL (not yet ported)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="(not yet ported)")
    ap.add_argument("--save", default=None, help="checkpoint path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    if args.host_mesh or args.multi_pod:
        raise NotImplementedError("--host-mesh / --multi-pod: sharded "
                                  "training is not yet ported")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    cfg = dataclasses.replace(cfg, remat=not args.smoke)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = build_model(cfg, device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
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

    state, _ = train_loop.train(
        model, gen, ocfg=ocfg, steps=args.steps,
        state=train_loop.init_state(model, None), callback=timed)
    step_s = [b - a for a, b in zip(marks, marks[1:])]
    tokens = args.batch * (args.seq if args.data == "lm" else args.seq | 1)
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 \
        if device.type == "cuda" else None
    run = TrainRun(state=state, step_s=step_s, losses=losses,
                   grad_norms=norms, tokens_per_step=tokens,
                   n_params=n_params, peak_gib=peak, device=str(device))
    _report(run, cfg)
    if args.save:
        ckpt.save(args.save, state.model, {"arch": cfg.name,
                                           "steps": args.steps})
        print("saved", args.save)
    return run


def _report(run: TrainRun, cfg) -> None:
    step = run.mean_step_s()
    line = (f"{cfg.name}: {run.n_params / 1e9:.3f} B params, "
            f"{run.tokens_per_step} tokens/step, step {step * 1e3:.1f} ms "
            f"(first {run.step_s[0] * 1e3:.1f} ms), "
            f"{run.tokens_per_step / step:.0f} tok/s on {run.device}")
    if run.peak_gib is not None:
        line += (f", peak {run.peak_gib:.2f} GiB, model-FLOP share "
                 f"{run.flop_share():.4f} of 989 TFLOP/s")
    print(line)


if __name__ == "__main__":
    main()
