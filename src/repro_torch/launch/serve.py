"""Serving launcher, one-shot batch mode (counterpart of
``repro/launch/serve.py``; continuous mode is not ported yet).

Runs on the CUDA card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --prompt-len 8192 --max-new 32 --method quoka

Weights are random from a seed unless ``--ckpt`` names a reference npz
checkpoint; latency does not depend on the weights.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models.model import build_model, resolve_device
from repro_torch.serving.engine import Engine
from repro_torch.training import checkpoint as ckpt


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--method", default="quoka", choices=("quoka", "full"))
    ap.add_argument("--budget", type=int, default=None)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--granularity", type=int, default=None,
                    help="selection granularity in tokens (default: config)")
    ap.add_argument("--fused", action="store_true",
                    help="fused selected attention (needs --granularity > 1)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke(n_layers=4, d_model=256, n_heads=8, n_kv_heads=2,
                        d_ff=512, vocab=2048)
    q = cfg.quoka
    if args.budget:
        q = dataclasses.replace(q, budget=args.budget)
    if args.granularity:
        q = dataclasses.replace(q, granularity=args.granularity)
    if args.fused:
        q = dataclasses.replace(q, fused_select_attn=True)
    cfg = dataclasses.replace(cfg, quoka=dataclasses.replace(
        q, chunk_size=min(q.chunk_size, args.prompt_len)))
    model = ckpt.restore(args.ckpt, cfg, device) if args.ckpt else \
        build_model(cfg, device)
    rng = np.random.default_rng(0)
    toks = rng.integers(3, cfg.vocab,
                        (args.batch, args.prompt_len)).astype(np.int32)
    eng = Engine(model, method=args.method, device=device)
    r = eng.generate({"tokens": toks}, args.max_new)
    print(f"{args.method:10s} TTFT {r.ttft_s * 1e3:9.1f} ms   "
          f"decode {r.decode_tps:8.1f} tok/s   "
          f"prompt {args.prompt_len} x {args.batch}   device {r.device}")
    return r


if __name__ == "__main__":
    main()
