"""Train a small model from scratch on the synthetic needle-retrieval task,
save it, then read it back through chunked prefill with QUOKA, dense
attention and two baselines on longer prompts: the in-repo NIAH experiment
(paper §4.1; counterpart of the reference's ``examples/train_retrieval.py``).

    PYTHONPATH=src python -m repro_torch.launch.train_retrieval \
        [--steps 400] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given; on the card the
prefill goes through the scoring and attention kernels.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.data.synthetic import (REF_SEED, needle_accuracy,
                                        needle_batch, needle_batches)
from repro_torch.models.model import build_model, resolve_device
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import loop as train_loop
from repro_torch.training import optimizer as opt

METHODS = ("full", "quoka", "sample_attention", "sparq")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ckpt", default="checkpoints/retrieval_model.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("llama3-2-3b").smoke(
        n_layers=args.layers, d_model=args.dim, n_heads=8, n_kv_heads=2,
        d_ff=args.dim * 3, vocab=512)
    cfg = dataclasses.replace(
        cfg, quoka=dataclasses.replace(cfg.quoka, chunk_size=64, budget=96,
                                       n_queries=8, keep_first=4))
    model = build_model(cfg, device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {args.layers}L d={args.dim} — {n_params/1e6:.1f}M params")

    gen = needle_batches(REF_SEED, cfg.vocab, 16, 129, n_keys=24)
    state, _ = train_loop.train(
        model, gen, steps=args.steps, log_every=50,
        state=train_loop.init_state(model, None),
        ocfg=opt.OptimizerConfig(lr=3e-3, warmup_steps=30,
                                 total_steps=args.steps))
    ckpt.save(args.ckpt, state.model, {"steps": args.steps,
                                       "arch": cfg.name})
    print(f"checkpoint saved to {args.ckpt}")

    print("\nNIAH evaluation (retrieval accuracy):")
    rng = np.random.default_rng(1)
    print(f"{'len':>6s} {'depth':>6s} " + " ".join(
        f"{m:>12s}" for m in ("full", "quoka", "sample_attn", "sparq")))
    table = {}
    for t in (129, 257, 513):
        for depth in (0.2, 0.8):
            batch = needle_batch(rng, cfg.vocab, 16, t, n_keys=24,
                                 depth=depth)
            accs = [needle_accuracy(model, batch, m) for m in METHODS]
            table[(t, depth)] = dict(zip(METHODS, accs))
            print(f"{t:6d} {depth:6.1f} " +
                  " ".join(f"{a:12.2f}" for a in accs))
    return table


if __name__ == "__main__":
    main()
