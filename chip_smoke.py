#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; nothing is caught):

  1. build the three CUDA kernels from ``src/repro_torch/kernels/csrc``;
  2. hold each kernel against its plain PyTorch version on the same bf16
     tensors at the main path's shapes, each error beside its tolerance;
  3. main path, staged route: qwen3-4b at full width (random weights from a
     seed), ``Engine.generate`` with QUOKA, batch 1, prompt 8192, 32 new
     tokens; launch counts must match the path's shape exactly;
  4. the same model on the fused route (granularity 16, fused selected
     attention): selected-attention launches on every selecting layer and
     no flash launch;
  5. small-input agreement: a smoke-size fp32 model on the card (kernels)
     and on the CPU (plain versions) gives the same logits and tokens;
  6. kernel timings at the main-path shapes (CUDA events around a CUDA
     graph replay of one call, with L2 as the main path leaves it for that
     kernel; the eager call's event and host times beside them) against
     their bound, the plain version and, for flash attention, one
     ``scaled_dot_product_attention`` call;
  7. a ``torch.profiler`` trace of a shorter staged prefill and a few
     decode steps: device busy time by kernel and the device idle share.

The last three lines are the card's name and power limit, one JSON line
with every kernel, and ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository's ``src`` next to it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12           # dense bf16 tensor-core peak
PROMPT, MAX_NEW = 8192, 32


def log(msg=""):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def bf16_ulp(x) -> float:
    top = float(x.float().abs().max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name, err, tol, why):
    log(f"  {name:44s} max err {err:.3e}  tol {tol:.3e}  ({why})")
    if not err <= tol:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")


# ---------------------------------------------------------------------------
# inputs at the main path's shapes (qwen3-4b: h=32, n_kv=8, d=128, bf16)
# ---------------------------------------------------------------------------

def score_inputs(torch, dev, n_q, start=4096, T=8224):
    g = torch.Generator(device=dev).manual_seed(10 + n_q)
    qb = torch.randn((1, 8, n_q, 128), generator=g, device=dev)
    qb = qb / qb.norm(dim=-1, keepdim=True)
    k = torch.randn((1, T, 8, 128), generator=g, device=dev).to(torch.bfloat16)
    pos = torch.arange(T, device=dev)[None]
    valid = pos < start                       # prior context; the tail is
    return qb, k.transpose(1, 2), valid       # the not-yet-written cap


def flash_inputs(torch, dev, tq):
    """[selected budget 1024 | chunk tq]: per-KV-head budget validity with
    -1 padding; KV head 3 selected nothing and its chunk key 0 is a pad
    slot, so query row 0 of that head group attends nothing."""
    B = 1024
    tk = B + tq
    g = torch.Generator(device=dev).manual_seed(20 + tq)
    q = torch.randn((1, tq, 32, 128), generator=g, device=dev)
    k = torch.randn((1, tk, 8, 128), generator=g, device=dev)
    v = torch.randn((1, tk, 8, 128), generator=g, device=dev)
    valid = torch.rand((1, 8, tk), generator=g, device=dev) < 0.9
    valid[:, :, B:] = True
    valid[:, 3, :B] = False
    valid[:, 3, B] = False
    bf = torch.bfloat16
    return (q.to(bf).transpose(1, 2), k.to(bf).transpose(1, 2),
            v.to(bf).transpose(1, 2), valid, B)


def selected_inputs(torch, np, dev, g, t, start, T=8224, B=1024):
    rng = np.random.default_rng(30 + g + t + start)
    gen = torch.Generator(device=dev).manual_seed(31 + g + t)
    bf = torch.bfloat16
    q = torch.randn((1, t, 32, 128), generator=gen, device=dev).to(bf)
    k = torch.randn((1, T, 8, 128), generator=gen, device=dev).to(bf)
    v = torch.randn((1, T, 8, 128), generator=gen, device=dev).to(bf)
    key_pos = torch.arange(T, dtype=torch.int32, device=dev)[None].clone()
    key_pos[:, start + t:] = -1
    if g > 1:
        hi = -(-max(start, 1) // g)                 # straddler included
        n = min(B // g - 3, hi)
        idx = np.full((1, B // g), -1, np.int64)
        idx[0, :n] = rng.choice(hi, size=n, replace=False)
    else:
        idx = np.full((1, 8, B), -1, np.int64)
        for h in range(8):
            n = min(B - 5, max(start, 1))
            idx[0, h, :n] = rng.choice(max(start + 2, 1), size=n,
                                       replace=False)
    return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), key_pos,
            torch.as_tensor(idx, device=dev), start)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_parity(torch, np, dev, K):
    """Phase 2.  Returns {kernel: max error over its cases}."""
    fa, qs, sa, ref = K["flash"], K["score"], K["selected"], K["ref"]
    errs = {}
    log("== phase 2: kernels against their plain versions (bf16)")
    e = 0.0
    for n_q in (16, 1):
        qb, kt, valid = score_inputs(torch, dev, n_q)
        got = qs.quoka_score_bhtd(qb, kt, valid)
        want = ref.score_ref(qb, kt, valid)
        err = max_err(got, want)
        check(f"quoka_score T=8224 n_q={n_q}", err, 1e-4,
              "fp32 scores of bf16 products, summation order differs")
        e = max(e, err)
    errs["quoka_score"] = e
    e = 0.0
    for tq in (128, 1):
        q, k, v, valid, B = flash_inputs(torch, dev, tq)
        got = fa.flash_attention_bhtd(q, k, v, valid, causal=True, boundary=B)
        want = ref.flash_attention_ref(q, k, v, causal=True, boundary=B,
                                       k_valid=valid)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("flash_attention: non-finite output")
        if float(got[:, 12:16, 0].abs().max()) != 0.0:
            raise AssertionError("flash_attention: fully-masked row not zero")
        err = max_err(got, want)
        check(f"flash_attention tq={tq} tk={B + tq} boundary={B}", err,
              bf16_ulp(want), "1 bf16 ulp of the output: fp32 sums, one "
              "rounding each")
        e = max(e, err)
    errs["flash_attention"] = e
    e = 0.0
    for g, t, start in ((16, 128, 4096), (16, 1, 8197), (16, 128, 0),
                        (1, 128, 4096), (1, 1, 8197)):
        q, k, v, key_pos, idx, st = selected_inputs(torch, np, dev, g, t,
                                                    start)
        got = sa.selected_attention_bhtd(q, k, v, key_pos, idx, st,
                                         granularity=g)
        want = ref.selected_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), key_pos, idx, st,
                                g).transpose(1, 2)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("selected_attention: non-finite output")
        err = max_err(got, want)
        check(f"selected_attention g={g} t={t} start={start}", err,
              bf16_ulp(want), "1 bf16 ulp of the output: fp32 sums, one "
              "rounding each")
        e = max(e, err)
    errs["selected_attention"] = e
    return errs


def reset_counts(K):
    for m in (K["score"], K["flash"], K["selected"]):
        m.LAUNCHES = 0


def read_counts(K):
    return {"quoka_score": K["score"].LAUNCHES,
            "flash_attention": K["flash"].LAUNCHES,
            "selected_attention": K["selected"].LAUNCHES}


def phase_main(torch, np, K, model, label):
    """Phases 3/4: one measured ``Engine.generate`` on the card.  A first
    call warms the signature (kernel build, allocator); the counts are set
    to 0 just before the measured call and read just after it."""
    from repro_torch.serving.engine import Engine
    cfg = model.cfg
    toks = np.random.default_rng(0).integers(
        3, cfg.vocab, (1, PROMPT)).astype(np.int32)
    eng = Engine(model, method="quoka")
    eng.generate({"tokens": toks}, MAX_NEW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(K)
    r = eng.generate({"tokens": toks}, MAX_NEW)
    counts = read_counts(K)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if r.tokens.shape != (1, MAX_NEW) or r.tokens.min() < 0 or \
            r.tokens.max() >= cfg.vocab:
        raise AssertionError(f"{label}: bad tokens {r.tokens}")
    log(f"  {label}: TTFT {r.ttft_s * 1e3:.1f} ms   decode "
        f"{r.decode_tps:.2f} tok/s   peak memory {peak:.2f} GiB   "
        f"launches {counts}")
    return r, counts, peak


def phase_small_agreement(torch, np):
    """Phase 5: a smoke-size fp32 qwen3-4b through the kernels on the card
    and through the plain versions on the CPU, same weights, staged and
    fused routes: logits within 1e-4 and identical greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, build_model
    from repro_torch.serving.engine import Engine
    log("== phase 5: small input, card (kernels) vs CPU (plain versions)")
    base = get_config("qwen3-4b").smoke()
    toks = np.random.default_rng(5).integers(3, base.vocab,
                                             (2, 64)).astype(np.int32)
    for label, qover in (("staged g=1", {}),
                         ("fused g=16", {"granularity": 16,
                                         "fused_select_attn": True})):
        cfg = dataclasses.replace(base, quoka=dataclasses.replace(
            base.quoka, **qover))
        cpu = build_model(cfg, device="cpu", seed=1)
        gpu = Model(cfg)
        gpu.load_state_dict(cpu.state_dict())
        lc, _ = cpu.prefill({"tokens": toks}, cpu.init_cache(2, 80))
        lg, _ = gpu.prefill({"tokens": toks}, gpu.init_cache(2, 80))
        err = max_err(lg.cpu(), lc)
        check(f"smoke prefill logits, {label}", err, 1e-4,
              "fp32 everywhere, summation order differs")
        tc = Engine(cpu, device="cpu").generate({"tokens": toks}, 8).tokens
        tg = Engine(gpu).generate({"tokens": toks}, 8).tokens
        if not np.array_equal(tc, tg):
            raise AssertionError(f"smoke greedy tokens differ, {label}: "
                                 f"{tc} vs {tg}")
        log(f"  smoke greedy tokens equal, {label}")


def phase_trace(torch, np, model, prompt=2048, steps=8):
    """Phase 7: where the time of the staged route goes.  One chunked
    prefill of ``prompt`` tokens and ``steps`` decode steps, each timed
    without the profiler (host clock around synchronize) and traced once
    with ``torch.profiler`` for the device time by kernel.  Device idle
    share = 1 - device busy time / untraced wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    log(f"== phase 7: trace, staged prefill of {prompt} tokens "
        f"({prompt // model.cfg.quoka.chunk_size} chunks) + {steps} "
        f"decode steps")
    toks = np.random.default_rng(7).integers(
        3, model.cfg.vocab, (1, prompt)).astype(np.int32)
    cap = prompt + steps

    def prefill():
        cache = model.init_cache(1, cap)
        lg, cache = model.prefill({"tokens": toks}, cache)
        return lg.argmax(-1), cache

    def decode(tok, cache):
        for i in range(steps):
            lg, cache = model.decode_step(tok, prompt + i, cache)
            tok = lg.argmax(-1)
        return tok

    def busy_us(prof):
        # device-side events only (kernels, memcpy, memset): the CPU ops
        # that launched them carry the same time and would count it twice
        total, by_name = 0.0, {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.self_device_time_total
            if us > 0:
                total += us
                by_name[e.key] = (us, e.count)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        return total, top

    out = {}
    tok, cache = prefill()                     # warm
    decode(tok, cache)
    for label in ("prefill", "decode"):
        torch.cuda.synchronize()
        if label == "prefill":
            t0 = time.perf_counter()
            tok, cache = prefill()
        else:
            t0 = time.perf_counter()
            decode(tok, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if label == "prefill":
                tok, cache = prefill()
            else:
                decode(tok, cache)
            torch.cuda.synchronize()
        busy, top = busy_us(prof)
        idle = 1.0 - busy * 1e-6 / wall
        # host work: torch ops issued per layer call (outermost aten ops)
        n_ops = sum(1 for e in prof.events() if e.name.startswith("aten::")
                    and (e.cpu_parent is None
                         or not e.cpu_parent.name.startswith("aten::")))
        calls = model.cfg.n_layers * (
            prompt // model.cfg.quoka.chunk_size if label == "prefill"
            else steps)
        log(f"  {label}: wall {wall * 1e3:.1f} ms untraced, device busy "
            f"{busy / 1e3:.1f} ms, idle share {idle:.3f}, "
            f"{n_ops / calls:.0f} torch ops per layer call")
        for name, (us, n) in top:
            log(f"    {us / 1e3:9.2f} ms  {n:5d} calls  {name[:90]}")
        out[label] = dict(wall_ms=wall * 1e3, busy_ms=busy / 1e3,
                          idle_share=idle, ops_per_layer_call=n_ops / calls,
                          top=[[nm[:90], us / 1e3, n]
                               for nm, (us, n) in top])
    return out


def time_ms(torch, fn, flush, iters=20):
    """Times of one ``fn`` call in ms, each a mean over ``iters`` calls,
    with ``flush()`` run before each (outside the timed span) unless it is
    None:

      device  CUDA events around the replay of a CUDA graph that captured
              the call: its kernels run with no Python in between, so this
              is the device's time for the work;
      eager   CUDA events around the eager call: the device time plus any
              gap while the device waits for the call's host code;
      host    host clock around the eager call, which only enqueues.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    out = {"device": 0.0, "eager": 0.0, "host": 0.0}
    for mode in ("device", "eager"):
        for _ in range(iters):
            if flush is not None:
                flush()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            t0 = time.perf_counter()
            if mode == "device":
                graph.replay()
            else:
                fn()
                out["host"] += (time.perf_counter() - t0) * 1e3 / iters
            e.record()
            e.synchronize()
            out[mode] += s.elapsed_time(e) / iters
    return out


def fmt(t) -> str:
    return (f"{t['device']:.4f} (eager {t['eager']:.4f}, "
            f"host {t['host']:.4f})")


def bound(nbytes, flops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / BF16_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def phase_timing(torch, np, dev, K):
    """Phase 6: each kernel at its main-path prefill shape (and decode
    shape, printed) against its bound, its plain version and, for flash,
    SDPA with the same mask."""
    import torch.nn.functional as F
    fa, qs, sa, ref = K["flash"], K["score"], K["selected"], K["ref"]
    junk = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        junk.fill_(1)

    log("== phase 6: kernel times (ms; device = graph replay)")
    rows = {}
    # scoring and selected attention read the layer's KV cache, which the
    # other layers' weights have pushed out of L2 since its last use: flush.
    # Score: a mid-prefill chunk (half the cap is prior context), the last
    # chunk and the first decode step (all of the prompt is).
    for n_q, start in ((16, 4096), (16, PROMPT), (1, PROMPT)):
        qb, kt, valid = score_inputs(torch, dev, n_q, start)
        out = torch.empty((1, 8, kt.shape[2]), device=dev)
        # an invalid slot scores NEG_INF unread: only valid key rows count
        n_valid = int(valid.sum())
        k_bytes = 8 * n_valid * 128 * kt.element_size()
        b_ms, b_by = bound(nbytes(qb.to(torch.bfloat16), valid, out)
                           + k_bytes, 2 * 8 * n_valid * 128 * (n_q + 1))
        ms = time_ms(torch, lambda: qs.quoka_score_bhtd(qb, kt, valid), flush)
        p_ms = time_ms(torch, lambda: ref.score_ref(qb, kt, valid), flush)
        log(f"  quoka_score n_q={n_q:2d} valid {n_valid}/{kt.shape[2]}: "
            f"{fmt(ms)}  plain {fmt(p_ms)}  bound {b_ms:.4f} ({b_by})")
        if n_q == 16 and start == 4096:
            rows["quoka_score"] = dict(ms=ms["device"],
                                       plain_ms=p_ms["device"],
                                       bound_ms=b_ms, bound_by=b_by,
                                       library_ms=None)
    for tq in (128, 1):
        q, k, v, valid, B = flash_inputs(torch, dev, tq)
        tk = k.shape[2]
        i = torch.arange(tq, device=dev)[:, None]
        j = torch.arange(tk, device=dev)[None, :]
        mask = ((j < B) | (j - B <= i))[None, None] & \
            valid.repeat_interleave(4, dim=1)[:, :, None, :]   # (1,32,tq,tk)
        pairs = int(mask.sum())
        out = torch.empty_like(q)
        # K/V rows masked by k_valid are never needed
        kv_bytes = 2 * int(valid.sum()) * 128 * k.element_size()
        b_ms, b_by = bound(nbytes(q, valid, out) + kv_bytes,
                           4 * 128 * pairs)
        # the main path feeds flash the [budget | chunk] tensors that the
        # concatenation has just written, warm in L2: no flush (the time
        # with L2 flushed is printed beside it)
        def call():
            return fa.flash_attention_bhtd(q, k, v, valid, causal=True,
                                           boundary=B)
        ms = time_ms(torch, call, None)
        cold = time_ms(torch, call, flush)["device"]
        p_ms = time_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, causal=True, boundary=B, k_valid=valid), None)
        kr = k.repeat_interleave(4, dim=1)
        vr = v.repeat_interleave(4, dim=1)
        l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kr, vr, attn_mask=mask), None)
        log(f"  flash_attention tq={tq:3d}: {fmt(ms)} L2-flushed {cold:.4f}  "
            f"plain {fmt(p_ms)}  sdpa {fmt(l_ms)}  bound {b_ms:.4f} "
            f"({b_by})")
        if tq == 128:
            rows["flash_attention"] = dict(ms=ms["device"],
                                           plain_ms=p_ms["device"],
                                           bound_ms=b_ms, bound_by=b_by,
                                           library_ms=l_ms["device"])
    for g, t, start in ((16, 128, 4096), (16, 1, 8197)):
        q, k, v, key_pos, idx, st = selected_inputs(torch, np, dev, g, t,
                                                    start)
        # keys this data needs: valid selected slots and the chunk rows
        blocks = idx[idx >= 0]
        rows_sel = (blocks[:, None] * g
                    + torch.arange(g, device=dev)).reshape(-1)
        pos_sel = key_pos[0, rows_sel]
        n_sel = int(((pos_sel >= 0) & (pos_sel < st)).sum())
        n_chunk_pairs = t * (t + 1) // 2
        pairs = 32 * (n_sel * t + n_chunk_pairs)
        out = torch.empty_like(q)
        kv_rows = 8 * (n_sel + t) * 128 * 2 * 2
        b_ms, b_by = bound(nbytes(q, out, idx) + kv_rows
                           + 4 * (len(rows_sel) + t), 4 * 128 * pairs)
        # the start as a device tensor: a graph cannot capture the
        # host-to-device copy that a Python int costs the plain version
        st_dev = torch.full((1,), st, dtype=torch.int32, device=dev)
        ms = time_ms(torch, lambda: sa.selected_attention_bhtd(
            q, k, v, key_pos, idx, st_dev, granularity=g), flush)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        p_ms = time_ms(torch, lambda: ref.selected_ref(
            qt, kt, vt, key_pos, idx, st_dev, g), flush)
        log(f"  selected_attention g={g} t={t:3d}: {fmt(ms)}  plain "
            f"{fmt(p_ms)}  bound {b_ms:.4f} ({b_by})")
        if t == 128:
            rows["selected_attention"] = dict(ms=ms["device"],
                                              plain_ms=p_ms["device"],
                                              bound_ms=b_ms, bound_by=b_by,
                                              library_ms=None)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quoka_score as qs
    from repro_torch.kernels import ref
    from repro_torch.kernels import selected_attention as sa
    from repro_torch.models.model import build_model
    K = {"flash": fa, "score": qs, "selected": sa, "ref": ref}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()

    log("== phase 1: build")
    t0 = time.perf_counter()
    build.library()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.last_build_seconds:.1f} s) from {build.CSRC}")
    for line in build.last_build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())
    log(card)

    errs = phase_parity(torch, np, dev, K)

    log("== phase 3: main path, staged (qwen3-4b full width, bf16)")
    cfg = get_config("qwen3-4b")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"  weights drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params")
    layers, chunks = cfg.n_layers, PROMPT // cfg.quoka.chunk_size
    per_run = layers * (chunks + MAX_NEW - 1)
    r_st, c_st, peak_st = phase_main(torch, np, K, model, "staged")
    want = {"quoka_score": per_run, "flash_attention": per_run,
            "selected_attention": 0}
    if c_st != want:
        raise AssertionError(f"staged launches {c_st} != {want}")
    with torch.no_grad():
        short = np.random.default_rng(1).integers(
            3, cfg.vocab, (1, 2048)).astype(np.int32)
        lg, _ = model.prefill({"tokens": short}, model.init_cache(1, 2080))
    if lg.shape != (1, cfg.vocab) or not bool(torch.isfinite(lg).all()):
        raise AssertionError("full-width prefill logits not finite")

    log("== phase 4: main path, fused (granularity 16)")
    model.cfg = dataclasses.replace(cfg, quoka=dataclasses.replace(
        cfg.quoka, granularity=16, fused_select_attn=True))
    r_fu, c_fu, peak_fu = phase_main(torch, np, K, model, "fused")
    want = {"quoka_score": per_run, "flash_attention": 0,
            "selected_attention": per_run}
    if c_fu != want:
        raise AssertionError(f"fused launches {c_fu} != {want}")
    model.cfg = cfg
    trace = phase_trace(torch, np, model)
    del model
    torch.cuda.empty_cache()

    phase_small_agreement(torch, np)
    timing = phase_timing(torch, np, dev, K)

    launches = {"quoka_score": c_st["quoka_score"],
                "flash_attention": c_st["flash_attention"],
                "selected_attention": c_fu["selected_attention"]}
    meta = {
        "quoka_score": ("src/repro_torch/kernels/csrc/quoka_score.cu",
                        "src/repro/kernels/quoka_score.py:45"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:93"),
        "selected_attention": (
            "src/repro_torch/kernels/csrc/selected_attention.cu",
            "src/repro/kernels/selected_attention.py:183"),
    }
    kernels = []
    for name, (src, repl) in meta.items():
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=repl, launches=launches[name],
                            max_abs_err=errs[name], **timing[name]))
    main_path = {
        "staged": dict(ttft_s=r_st.ttft_s, decode_tok_s=r_st.decode_tps,
                       peak_gib=peak_st),
        "fused": dict(ttft_s=r_fu.ttft_s, decode_tok_s=r_fu.decode_tps,
                      peak_gib=peak_fu)}
    log(json.dumps({"main_path": main_path, "trace": trace}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
