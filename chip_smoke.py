#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; nothing is caught):

  1. build the four CUDA kernels from ``src/repro_torch/kernels/csrc``;
  2. hold each kernel against its plain PyTorch version on the same bf16
     tensors at the main path's shapes, each error beside its tolerance;
     scoring also at d = 80 and d = 576 (small T, bf16 and fp32) with a
     row that has no valid slot (exactly NEG_INF), and at the projected
     d = 32 and 64 of low-rank scoring (n_q 16 and 1, T 8224); scoring,
     flash and selected attention at llama3-2-3b's shapes (GQA group 3,
     d = 128) and stablelm-3b's (MHA 32 / 32, d = 80); flash, selected and
     paged attention at d = 8, 32, 80, 112 and 120, fp32 and bf16, GQA
     groups 1, 3 and 7, each with a row that has no valid key (exact
     zeros), paged equal to linear bit for bit; flash at deepseek-v3's
     prefill and decode shapes (128 heads over one latent KV head, d 576,
     V the 512-wide latent and V zero-padded to 576), bf16 and fp32, rows
     with no valid key exact zeros, the unpadded output equal to the
     padded call's first 512 columns; scoring at h2o-danube-3-4b's wrapped
     ring (n_kv 8, d 120 staged at 128, T 4096, n_q 16 and 1, bf16 and
     fp32, a row with no valid slot exactly NEG_INF), and flash and
     selected attention at gemma3-27b's global layers (h 32 / 16, budget
     2048: [2048 | 128] keys, 128 plan blocks; prefill and decode), and
     scoring (n_q 16 and 1), flash and selected attention (g 16 and 1) at
     zamba2-7b's shared block (MHA 32 / 32, d 112), at whisper-small's
     decoder self-attention (MHA 12 / 12, d 64, budget 512: [512 | tq]
     keys, 32 plan blocks) and at internvl2-1b's LM (GQA 14 / 2, a group
     of 7, d 64);
  3. main path, staged route: qwen3-4b at full width (random weights from a
     seed), ``Engine.generate`` with QUOKA, batch 1, prompt 8192, 32 new
     tokens; launch counts must match the path's shape exactly;
  4. the same model on the fused route (granularity 16, fused selected
     attention): selected-attention launches on every selecting layer and
     no flash launch;
  5. small-input agreement: a smoke-size fp32 model on the card (kernels)
     and on the CPU (plain versions) gives the same logits and tokens;
  6. kernel timings at the main-path shapes, prefill and decode (CUDA
     events around a CUDA graph replay of one call, with L2 as the main
     path leaves it for that kernel, and with L2 warm and flushed both;
     the eager call's event and host times beside them; and 20 calls back
     to back in one graph, each scoring call on its own copy of the cache)
     against their bound, the plain version and, for flash attention, one
     ``scaled_dot_product_attention`` call; for scoring and the bf16
     attention kernels, the grids of the kernels one call launched and
     their device time, read from a ``torch.profiler`` trace (the blocks
     per launch and, for attention, the split count S); flash and selected
     attention also at stablelm-3b's shapes (d = 80, MHA) and gemma3-27b's
     (group 2, budget 2048), flash at deepseek-v3's (d 576, beside SDPA
     and the backend SDPA took), scoring at its latent (n_kv 1, d 576), at
     h2o-danube-3-4b's ring (d 120) and at zamba2-7b's shared block (n_kv
     32, d 112; mid-prefill and decode), flash and selected attention at
     that block's shapes too, and all three at whisper-small's decoder
     (MHA 12 / 12, d 64, budget 512) and internvl2-1b's LM (GQA 14 / 2, d
     64), prefill and decode;
  7. a ``torch.profiler`` trace of a shorter staged prefill and a few
     decode steps: device busy time by kernel and the device idle share;
  8. continuous batching at full width: qwen3-4b on the fused route serves
     a trace of three requests (8192, 3000 and 1024 prompt tokens) through
     ``Engine.serve`` over the paged pool, then a second trace on the same
     state whose prompt shares 4096 tokens with the first request (a
     prefix hit of exactly 4096 tokens); launch counts must be exactly one
     score and one selected-attention launch per layer per step, no flash
     launch and no paged launch (the serve step gathers a linear view, as
     the reference's does); a third trace (a 4096-token hit beside fresh
     prompts, ragged tails, an idle row) holds every score and
     selected-attention call of the run to its plain version at the
     geometry the step gives it; a profiled fourth trace gives the gather
     and scatter device time and the idle share of the serve path;
  9. the paged kernel on that pool: layer 0's pool leaves, the first
     trace's block tables plus a row with a -1 hole and a mapped recycled
     block of stale positions (a plan id forced into each) and an idle
     row, per-row starts, plan ids built on the gathered view (prefill
     chunk, decode; g = 16 and g = 1), held to its plain version and, bit
     for bit, to the linear kernel on the gathered view;
 10. small-input agreement of the serve path: a smoke-size fp32 model
     serves the same trace on the card and on the CPU, and the tokens
     equal each other and each request's own ``generate``;
 11. every selection method through ``Engine.generate`` at qwen3-4b full
     width cut in depth to 12 of its 36 layers, to keep the run inside
     its time limit (prompt 4096, 8 new tokens): ``full``, ``quoka``, the
     six baselines, ``quoka`` with plan reuse (interval 4, corrections 0
     and 11) and with ``score_proj_dim`` 32, staged; two baselines fused;
     TTFT, decode rate, greedy tokens and exact launch counts for each;
 12. the chunked-prefill harness on the card: output error, key recall and
     critical key recall of every method, staged and fused, at qwen3-4b's
     attention geometry (T = 8192, bf16); budget = T equals the dense
     oracle; at a small size the card equals the CPU for every method and
     QUOKA's key recall beats SampleAttention's;
 13. every baseline serves a smoke-size model on the card and on the CPU
     with equal tokens;
 14. llama3-2-3b (d_model 3072, 24 / 8 heads, d 128) at full width from
     random weights, cut in depth to 4 of its 28 layers to keep the run
     inside its time limit: ``Engine.generate`` staged and fused at
     prompt 8192, 32 new tokens, with exact launch counts (4 x 95 per
     kernel and run);
 15. stablelm-3b (d_model 2560, 32 / 32 heads, d 80) the same way, cut to
     4 of its 32 layers (4 x 95);
 16. the host-memory tier on llama3-2-3b ``serve`` (fused g = 16; block
     128, a 64-block device pool, a 128-block pinned host tier, prefetch
     depth 4, one decode row; run after phase 14 on its 4-layer model): A (6144
     tokens), then B (6144 other tokens) whose pressure demotes most of A,
     then [B, A], where A's host blocks are staged during B's steps and
     promoted at A's admission; greedy tokens equal a 256-block pool with
     no tier and ``generate``; one block held byte for byte through
     demotion and promotion; every slab's H2D copy in a profiler trace
     from pinned memory, on a side stream, inside one step's compute span;
     A's cold and promoted TTFT;
 17. olmoe-1b-7b (16 layers, d_model 2048, MHA 16 / 16, 64 experts top-8,
     capacity dispatch) at full width: ``Engine.generate`` staged and fused
     with exact launch counts (16 x 95), layer 0's capacity dispatch on the
     card against the CPU (fp32: the same dropped pairs, outputs within
     1e-4 relative), and a serve of three requests (8192, 3000, 2048
     tokens) with one prefill and one decode row, whose whole-chunk
     requests (8192 and 2048 tokens) equal their own ``generate``;
 18. deepseek-v3's attention and expert geometry cut to 4 layers (3 dense
     MLA, 1 MLA + 256 experts): ``Engine.generate`` staged with exact
     launch counts (4 x 95), and layer 0's selected attention (flash at d
     576 over the latent) held to its plain version on its own inputs;
 19. that model served over the paged pool with the host tier (latent
     caches in 128-slot blocks, 72 device blocks, 128 pinned slabs,
     prefetch depth 4, one prefill and one decode row): A (8192 tokens),
     B (a 4096-token prefix hit on A whose fresh blocks demote A's tail),
     then [C (2048 tokens), A] (A staged during C's steps and promoted);
     exact launch counts, every request's tokens equal its ``generate``,
     every slab of A byte-exact through demotion and promotion, TTFT per
     request; the serve step's last prefill and decode flash calls held to
     the plain version and timed beside SDPA, each timed call held to one
     launch of the flash kernel by its launch counter (the profiler does
     not record them reliably here);
 20. h2o-danube-3-4b (24 layers, d_model 3840, 32 / 8 heads, d 120, every
     layer windowed at 4096) at full width: ``Engine.generate`` at prompt
     8192 (every ring wraps), staged and g = 16, with exact launch counts
     (scoring on every layer call, 24 x 95; no flash, no selected
     attention: a windowed layer attends on the plain masked path), and a
     trace of its fused route as phase 7's;
 21. gemma3-27b's and h2o-danube-3-4b's smoke configs (window 64) at
     prompt 160, card (kernels) vs CPU (plain versions): logits within
     1e-4, greedy tokens equal, staged and g = 16;
 22. gemma3-27b (d_model 5376, 32 / 16 heads, 5 local (window 1024) : 1
     global, budget 2048) at full width, cut in depth to two of its ten
     periods (12 of 62 layers) to keep the run inside its time limit:
     ``Engine.generate`` staged and fused (g = 16) with exact launch
     counts (2 global layers x 95; the local layers' 1024-slot rings take
     the dense bypass), and a trace of the fused route as phase 7's at
     prompt 4096 (at 2048 every layer would take the dense bypass);
 23. zamba2-7b (81 layers: 13 x (5 Mamba2 + 1 Mamba2 followed by the ONE
     shared attention block, MHA 32 / 32 at d 112) + 3 Mamba2; d_model
     3584) at full width and depth: ``Engine.generate`` staged and fused
     (g = 16) with exact launch counts (13 shared-block uses x 95 per
     kernel and route; the Mamba2 layers launch nothing), and a trace of
     the fused route as phase 7's with the device time of the SSD scan,
     the causal convolution, the shared block (its kernels apart) and the
     products;
 24. rwkv6-1.6b (24 RWKV6 layers, d_model 2048, no KV cache) at full
     width and depth: ``Engine.generate`` with QUOKA asked for and 0
     launches of every kernel (nothing to select), and a trace with the
     wkv scan's device time;
 25. zamba2-7b's smoke config (staged and g = 16) and rwkv6-1.6b's in
     fp32 at prompt 160, card (kernels) vs CPU (plain versions): logits
     within 1e-4, greedy tokens equal;
 26. whisper-small (12 decoder layers: causal self-attention, MHA 12 /
     12 at d 64 with budget 512, cross-attention and a gelu MLP, all with
     LayerNorm; a 12-layer encoder over 1500 frames drawn from a numpy
     seed) at full width and depth: ``Engine.generate`` at prompt 8192
     (beyond whisper's published 448-token context: at 448 + 32 every
     layer takes the dense bypass), staged and fused (g = 16), with exact
     launch counts (12 x 95 per kernel and route; the encoder and
     cross-attention launch nothing), TTFT with the encoder, decode rate,
     peak memory, and a trace of the fused route with the device time of
     the encoder, the cross-KV build and the cross-attention;
 27. internvl2-1b (24 layers, d_model 896, GQA 14 / 2, d 64; a projector
     of 256 patches of d 1024 ahead of 7936 tokens: 8192 positions) the
     same way (24 x 95), its trace (the prefill through ``embed_inputs``,
     the patches ahead of the tokens) with the projector's device time,
     which CUDA events also time outside the profiler;
 28. both smoke configs in fp32 (whisper at prompt 160 over 64 frames,
     internvl2 at 16 patches + 144 tokens), staged and g = 16, card
     (kernels) vs CPU (plain versions): logits within 1e-4, greedy tokens
     equal;
 29. granite-3-2b trained at full width (40 layers, d 2048, GQA 32 / 8,
     d_ff 8192, vocab 49155; bf16, each layer recomputed in the backward)
     through ``launch/train.py``, 3 steps of batch 8 x 256: every loss and
     gradient norm finite, every weight matrix changed; step time (first
     step off the clock), tokens/s, peak memory, model-FLOP share; then a
     smoke-width training state saved and restored on the card;
 30. one fp32 training step of every family's smoke config (granite,
     gemma3, olmoe, deepseek-v3 with MTP, zamba2, rwkv6, whisper,
     internvl2), card vs CPU, remat off and on: loss and gradient norm
     within 1e-5 relative, gradients within 1e-4 of each leaf's largest
     magnitude (rwkv6 5e-3).  Training runs on plain torch: no kernel;
 31. the retrieval model of the reference's ``tests/test_system.py``
     trained on the card (250 steps), then read back through chunked
     prefill: dense accuracy at 97 tokens >= 0.7; at 161 tokens QUOKA
     >= dense - 0.25 with the scoring and flash kernels launched once per
     counted chunk call and layer;
 32. serve-path telemetry (run right after phase 9, on phase 8's fused
     qwen3-4b, so no second 4 B model is drawn): one short trace (a
     4096-token prefix hit beside fresh prompts of 600 and 300 tokens,
     after a priming request that registers the prefix) served by
     ``Engine``s with a live ``obs.Registry`` and with none, in the order
     on, off, off, on, each on a fresh pool of equal geometry: identical
     greedy tokens, launch
     counts (score and selected = 36 x step calls, flash and paged 0) and
     ``Engine.stats``; at every step of both registry-on runs, every
     selecting layer's kv_fraction at or under its budget fraction (and
     the ``select/layerNN/*`` gauges so at the end);
     ``select/plan_refresh`` = 36 x the step calls; telemetry's cached
     constants unchanged by the second registry-on run; the ``sched/*``
     counters equal the ``ServeResult`` fields; the Chrome trace of
     ``obs.export_all`` parses; the wall-time ratio of registry on to off
     and the mean selected-KV fraction are printed.  Then the cost of
     ``with_obs`` on one full-width decode step (kernel launches from a
     CPU-activity profile, host wall), and a smoke-size fp32 model's
     ``LayerObs`` from ``prefill_chunk`` / ``decode_step(with_obs=True)``,
     staged and fused (g = 16), reuse interval 2, through
     ``tests/test_torch_cuda.py``'s ``layer_obs_card_vs_cpu``: card equal
     to CPU (counts exactly, the score sketch within 2e-5, NaN in the
     same places).

The last three lines are the card's name and power limit, one JSON line
with every kernel (``launches`` from phases 3-4, ``paths`` the launches
of every one-shot path; the training phases launch none), and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src`` next to it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

PROMPT, MAX_NEW = 8192, 32
SERVE_NEW = 16                     # new tokens per request in phase 8


_T0 = time.perf_counter()


def log(msg=""):
    """Print a line; a phase's header carries the script's elapsed time."""
    if msg.startswith("== "):
        msg = f"{msg}  [{time.perf_counter() - _T0:.0f} s]"
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

def score_inputs(torch, dev, n_q, start=4096, T=8224, n_kv=8, d=128):
    g = torch.Generator(device=dev).manual_seed(10 + n_q)
    qb = torch.randn((1, n_kv, n_q, d), generator=g, device=dev)
    qb = qb / qb.norm(dim=-1, keepdim=True)
    k = torch.randn((1, T, n_kv, d), generator=g,
                    device=dev).to(torch.bfloat16)
    pos = torch.arange(T, device=dev)[None]
    valid = pos < start                       # prior context; the tail is
    return qb, k.transpose(1, 2), valid       # the not-yet-written cap


def projected_score_inputs(torch, dev, n_q, r, start=4096):
    """``score_inputs`` projected to rank r as ``ops.score(proj=)`` does it:
    q̄ in fp32, K in bf16 (the cached projection of ``score_proj_dim``)."""
    from repro_torch.kernels import ops
    qb, kt, valid = score_inputs(torch, dev, n_q, start)
    proj = ops.score_projection(128, r, dev)
    kp = kt.transpose(1, 2) @ proj.to(kt.dtype)
    return qb @ proj, kp.transpose(1, 2), valid


def small_score_inputs(torch, dev, n_q, d, dtype, T=300):
    """Two rows at small T, q̄ in the main path's (b, n_q, n_kv, d) layout
    viewed as BHND: row 0 with random validity, row 1 with none."""
    g = torch.Generator(device=dev).manual_seed(40 + d + n_q)
    qb = torch.randn((2, n_q, 2, d), generator=g, device=dev).transpose(1, 2)
    qb = qb / qb.norm(dim=-1, keepdim=True)
    k = torch.randn((2, T, 2, d), generator=g, device=dev).to(dtype)
    valid = torch.rand((2, T), generator=g, device=dev) < 0.8
    valid[1] = False
    return qb, k.transpose(1, 2), valid


# h2o-danube-3-4b's scoring call (phase 20's path): its ring of 4096 slots
# (window 4096), n_kv 8, d 120, at the chunk of an 8192-token prompt that
# starts at 6016, mid-ring
RING_T, RING_D, RING_START = 4096, 120, 6016


def ring_score_inputs(torch, dev, n_q, dtype, b=1):
    """q̄ (b, 8, n_q, 120) and a wrapped ring of 4096 slots: slot j holds
    the newest position p <= the chunk's last with p % 4096 == j, so the
    slots hold positions 4096-6015, then the chunk's own 128 (not yet prior
    context: invalid), then 2048-4095: no monotonic order.  With b = 2 the
    second row has no valid slot."""
    g = torch.Generator(device=dev).manual_seed(60 + n_q)
    qb = torch.randn((b, 8, n_q, RING_D), generator=g, device=dev)
    qb = qb / qb.norm(dim=-1, keepdim=True)
    k = torch.randn((b, RING_T, 8, RING_D), generator=g,
                    device=dev).to(dtype)
    last = RING_START + 127
    slot = torch.arange(RING_T, device=dev)
    pos = last - (last - slot) % RING_T
    valid = ((pos >= 0) & (pos < RING_START))[None].repeat(b, 1)
    if b > 1:
        valid[1] = False
    return qb, k.transpose(1, 2), valid


def empty_head(n_kv) -> int:
    """The KV head ``flash_inputs`` leaves with no valid key for query row
    0: head 3, or the last where there are fewer."""
    return min(3, n_kv - 1)


def flash_inputs(torch, dev, tq, h=32, n_kv=8, d=128, B=1024, empty=True):
    """[selected budget B | chunk tq]: per-KV-head budget validity with
    -1 padding; with ``empty``, KV head ``empty_head(n_kv)`` selected
    nothing and its chunk key 0 is a pad slot, so query row 0 of that head
    group attends nothing."""
    tk = B + tq
    g = torch.Generator(device=dev).manual_seed(20 + tq)
    q = torch.randn((1, tq, h, d), generator=g, device=dev)
    k = torch.randn((1, tk, n_kv, d), generator=g, device=dev)
    v = torch.randn((1, tk, n_kv, d), generator=g, device=dev)
    valid = torch.rand((1, n_kv, tk), generator=g, device=dev) < 0.9
    valid[:, :, B:] = True
    if empty:
        valid[:, empty_head(n_kv), :B + 1] = False
    bf = torch.bfloat16
    return (q.to(bf).transpose(1, 2), k.to(bf).transpose(1, 2),
            v.to(bf).transpose(1, 2), valid, B)


# deepseek-v3's flash call (phase 18's path): absorbed queries of 128 heads
# over one latent KV head, [latent 512 | rope 64] keys, the latent as V
MLA_H, MLA_D, MLA_DV = 128, 576, 512
MLA_SCALE = 192 ** -0.5                 # 1 / sqrt(qk_nope 128 + qk_rope 64)


def mla_flash_inputs(torch, dev, tq, dtype, b=1):
    """MLABlock's flash call at deepseek-v3's width: q (b, 128, tq, 576)
    over [selected budget 1024 | chunk tq] keys (b, 1, 1024 + tq, 576), a
    tenth of the budget invalid (selection padding); V is the 512-wide
    latent, the keys' first 512 columns (a view, as the block passes it).
    With b = 2 the second row has no valid budget key and its first four
    chunk keys are pad slots: its first four query rows attend nothing."""
    B = 1024
    tk = B + tq
    g = torch.Generator(device=dev).manual_seed(50 + tq)
    q = torch.randn((b, tq, MLA_H, MLA_D), generator=g, device=dev)
    k = torch.randn((b, tk, 1, MLA_D), generator=g, device=dev)
    valid = torch.rand((b, tk), generator=g, device=dev) < 0.9
    valid[:, B:] = True
    if b > 1:
        valid[1, :B + 4] = False
    q = q.to(dtype).transpose(1, 2)
    k = k.to(dtype).transpose(1, 2)
    return q, k, k[..., :MLA_DV], valid, B


def selected_inputs(torch, np, dev, g, t, start, T=8224, B=1024, h=32,
                    n_kv=8, d=128):
    rng = np.random.default_rng(30 + g + t + start)
    gen = torch.Generator(device=dev).manual_seed(31 + g + t)
    bf = torch.bfloat16
    q = torch.randn((1, t, h, d), generator=gen, device=dev).to(bf)
    k = torch.randn((1, T, n_kv, d), generator=gen, device=dev).to(bf)
    v = torch.randn((1, T, n_kv, d), generator=gen, device=dev).to(bf)
    key_pos = torch.arange(T, dtype=torch.int32, device=dev)[None].clone()
    key_pos[:, start + t:] = -1
    if g > 1:
        hi = -(-max(start, 1) // g)                 # straddler included
        n = min(B // g - 3, hi)
        idx = np.full((1, B // g), -1, np.int64)
        idx[0, :n] = rng.choice(hi, size=n, replace=False)
    else:
        idx = np.full((1, n_kv, B), -1, np.int64)
        for hh in range(n_kv):
            n = min(B - 5, max(start, 1))
            idx[0, hh, :n] = rng.choice(max(start + 2, 1), size=n,
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
    # deepseek-v3's latent (phase 18): one KV head, d = 576, prompt 8192
    for n_q in (16, 1):
        qb, kt, valid = score_inputs(torch, dev, n_q, start=PROMPT, n_kv=1,
                                     d=576)
        err = max_err(qs.quoka_score_bhtd(qb, kt, valid),
                      ref.score_ref(qb, kt, valid))
        check(f"deepseek-v3 quoka_score T=8224 n_q={n_q} n_kv=1 d=576", err,
              1e-4, "fp32 scores of bf16 products, summation order differs")
        e = max(e, err)
    for d, n_q in ((80, 5), (576, 16)):
        for dtype, tol, why in (
                (torch.bfloat16, 1e-4, "fp32 scores of bf16 products"),
                (torch.float32, 2e-5, "fp32 on the CUDA cores")):
            qb, kt, valid = small_score_inputs(torch, dev, n_q, d, dtype)
            got = qs.quoka_score_bhtd(qb, kt, valid)
            want = ref.score_ref(qb, kt, valid)
            if not bool((got[1] == ref.NEG_INF).all()):
                raise AssertionError("quoka_score: a row with no valid "
                                     "slot is not exactly NEG_INF")
            err = max_err(got, want)
            check(f"quoka_score T=300 d={d} n_q={n_q} "
                  f"{str(dtype)[6:]}", err, tol,
                  f"{why}, summation order differs")
            e = max(e, err)
    # low-rank scoring (score_proj_dim): q̄ and K projected from d = 128
    # to r, the kernel at head dim r
    for r in (32, 64):
        for n_q in (16, 1):
            qb, kt, valid = projected_score_inputs(torch, dev, n_q, r)
            got = qs.quoka_score_bhtd(qb, kt, valid)
            want = ref.score_ref(qb, kt, valid)
            err = max_err(got, want)
            check(f"quoka_score T=8224 n_q={n_q} projected d={r}", err,
                  1e-4, "fp32 scores of bf16 products, summation order "
                  "differs")
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
    # the other main paths at their shapes: llama3-2-3b (GQA group 3, d =
    # 128), stablelm-3b (MHA 32 / 32, d = 80), olmoe-1b-7b (MHA 16 / 16, d
    # = 128), ..., whisper-small (MHA 12 / 12, d = 64, budget 512) and
    # internvl2-1b (GQA 14 / 2, a group of 7, d = 64)
    for arch, (h, n_kv, d) in ARCH_SHAPES.items():
        group = h // n_kv
        hz = empty_head(n_kv)
        budget = ARCH_BUDGETS.get(arch, 1024)
        for n_q in (16, 1):
            qb, kt, valid = score_inputs(torch, dev, n_q, n_kv=n_kv, d=d)
            err = max_err(qs.quoka_score_bhtd(qb, kt, valid),
                          ref.score_ref(qb, kt, valid))
            check(f"{arch} quoka_score n_q={n_q} d={d}", err, 1e-4,
                  "fp32 scores of bf16 products, summation order differs")
            errs["quoka_score"] = max(errs["quoka_score"], err)
        for tq in (128, 1):
            q, k, v, valid, B = flash_inputs(torch, dev, tq, h, n_kv, d,
                                             B=budget)
            got = fa.flash_attention_bhtd(q, k, v, valid, causal=True,
                                          boundary=B)
            want = ref.flash_attention_ref(q, k, v, causal=True, boundary=B,
                                           k_valid=valid)
            if float(got[:, hz * group:(hz + 1) * group, 0].abs().max()) \
                    != 0.0:
                raise AssertionError(f"{arch} flash_attention: fully-masked "
                                     "row not zero")
            err = max_err(got, want)
            check(f"{arch} flash_attention tq={tq} tk={B + tq} h={h}/{n_kv} "
                  f"d={d}", err, bf16_ulp(want), "1 bf16 ulp of the output")
            errs["flash_attention"] = max(errs["flash_attention"], err)
        for g, t, start in ((16, 128, 4096), (16, 1, 8197), (1, 128, 4096),
                            (1, 1, 8197)):
            q, k, v, key_pos, idx, st = selected_inputs(
                torch, np, dev, g, t, start, B=budget, h=h, n_kv=n_kv, d=d)
            got = sa.selected_attention_bhtd(q, k, v, key_pos, idx, st,
                                             granularity=g)
            want = ref.selected_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), key_pos, idx, st,
                                    g).transpose(1, 2)
            err = max_err(got, want)
            check(f"{arch} selected_attention g={g} t={t} B={budget} d={d}",
                  err, bf16_ulp(want), "1 bf16 ulp of the output")
            errs["selected_attention"] = max(errs["selected_attention"], err)
    for name, err in window_parity(torch, np, dev, K).items():
        errs[name] = max(errs[name], err)
    for name, err in head_dim_sweep(torch, np, dev, K).items():
        errs[name] = max(errs.get(name, 0.0), err)
    errs["flash_attention"] = max(errs["flash_attention"],
                                  mla_flash_parity(torch, dev, K))
    return errs


def window_parity(torch, np, dev, K):
    """Phase 2, the sliding-window slice's shapes: scoring at
    h2o-danube-3-4b's wrapped ring (n_kv 8, d 120: staged at 128 with the
    missing columns zero-filled; T 4096, n_q 16 and 1, bf16 and fp32, a
    row with no valid slot exactly NEG_INF), and flash and selected
    attention at gemma3-27b's global layers (h 32 / 16, a budget of 2048
    keys: 128 plan blocks at g = 16; prefill and decode).  Returns
    {kernel: max error}."""
    fa, qs, sa, ref = K["flash"], K["score"], K["selected"], K["ref"]
    errs = {"quoka_score": 0.0, "flash_attention": 0.0,
            "selected_attention": 0.0}
    for n_q in (16, 1):
        for dtype, tol, why in (
                (torch.bfloat16, 1e-4, "fp32 scores of bf16 products"),
                (torch.float32, 2e-5, "fp32 on the CUDA cores")):
            qb, kt, valid = ring_score_inputs(torch, dev, n_q, dtype, b=2)
            got = qs.quoka_score_bhtd(qb, kt, valid)
            want = ref.score_ref(qb, kt, valid)
            if not bool((got[1] == ref.NEG_INF).all()):
                raise AssertionError("quoka_score d=120: a row with no "
                                     "valid slot is not exactly NEG_INF")
            err = max_err(got, want)
            check(f"h2o-danube quoka_score ring T={RING_T} n_q={n_q} "
                  f"d={RING_D} {str(dtype)[6:]}", err, tol,
                  f"{why}, summation order differs")
            errs["quoka_score"] = max(errs["quoka_score"], err)
    h, n_kv, d = ARCH_SHAPES["gemma3-27b"]
    group = h // n_kv
    for tq in (128, 1):
        q, k, v, valid, B = flash_inputs(torch, dev, tq, h, n_kv, d,
                                         B=GEMMA_BUDGET)
        got = fa.flash_attention_bhtd(q, k, v, valid, causal=True,
                                      boundary=B)
        want = ref.flash_attention_ref(q, k, v, causal=True, boundary=B,
                                       k_valid=valid)
        hz = empty_head(n_kv)
        if float(got[:, hz * group:(hz + 1) * group, 0].abs().max()) != 0.0:
            raise AssertionError("gemma3 flash_attention: fully-masked row "
                                 "not zero")
        err = max_err(got, want)
        check(f"gemma3 flash_attention tq={tq} tk={B + tq} h={h}/{n_kv}",
              err, bf16_ulp(want), "1 bf16 ulp of the output")
        errs["flash_attention"] = max(errs["flash_attention"], err)
    for g, t, start in ((16, 128, 4096), (16, 1, 8197)):
        q, k, v, key_pos, idx, st = selected_inputs(
            torch, np, dev, g, t, start, B=GEMMA_BUDGET, h=h, n_kv=n_kv,
            d=d)
        got = sa.selected_attention_bhtd(q, k, v, key_pos, idx, st,
                                         granularity=g)
        want = ref.selected_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), key_pos, idx, st,
                                g).transpose(1, 2)
        err = max_err(got, want)
        check(f"gemma3 selected_attention g={g} t={t} blocks "
              f"{idx.shape[1]} h={h}/{n_kv}", err, bf16_ulp(want),
              "1 bf16 ulp of the output")
        errs["selected_attention"] = max(errs["selected_attention"], err)
    return errs


def mla_flash_parity(torch, dev, K):
    """Phase 2, deepseek-v3's flash shapes (prefill tq 128 and decode, b 2)
    on the wide tile, bf16 and fp32: the 512-wide latent as V, and V
    zero-padded to 576 as the reference passes it; each against the plain
    version, the unpadded output against the padded call's first 512
    columns, and the rows with no valid key exact zeros."""
    import torch.nn.functional as F
    fa, ref = K["flash"], K["ref"]
    e = 0.0
    for tq in (128, 1):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, valid, B = mla_flash_inputs(torch, dev, tq, dtype, b=2)
            v_pad = F.pad(v, (0, MLA_D - MLA_DV))
            kw = dict(causal=True, boundary=B, scale=MLA_SCALE)
            got = fa.flash_attention_bhtd(q, k, v, valid, **kw)
            pad = fa.flash_attention_bhtd(q, k, v_pad, valid, **kw)
            want = ref.flash_attention_ref(q, k, v, k_valid=valid, **kw)
            want_pad = ref.flash_attention_ref(q, k, v_pad, k_valid=valid,
                                               **kw)
            if got.shape != (2, MLA_H, tq, MLA_DV) or \
                    not bool(torch.isfinite(got).all()):
                raise AssertionError(f"MLA flash: shape {tuple(got.shape)} "
                                     "or non-finite output")
            for x in (got, pad):
                if float(x[1, :, :min(4, tq)].abs().max()) != 0.0:
                    raise AssertionError("MLA flash: a row with no valid "
                                         "key is not exactly zero")
            bf = dtype == torch.bfloat16
            tol = bf16_ulp(want) if bf else 2e-5
            why = "1 bf16 ulp of the output" if bf else \
                "fp32 on the CUDA cores, summation order differs"
            label = f"MLA flash_attention tq={tq} d=576 {str(dtype)[6:]}"
            for name, x, w in (("dv=512", got, want),
                               ("dv=576 (padded V)", pad, want_pad),
                               ("dv=512 vs padded[:512]", got,
                                pad[..., :MLA_DV])):
                err = max_err(x, w)
                check(f"{label} {name}", err, tol, why)
                e = max(e, err)
    return e


# (h, n_kv, d) of the other models (phases 14, 15, 17, 20, 22, 23;
# zamba2-7b's: its shared attention block)
ARCH_SHAPES = {"llama3-2-3b": (24, 8, 128), "stablelm-3b": (32, 32, 80),
               "olmoe-1b-7b": (16, 16, 128), "gemma3-27b": (32, 16, 128),
               "h2o-danube-3-4b": (32, 8, 120), "zamba2-7b": (32, 32, 112),
               "whisper-small": (12, 12, 64), "internvl2-1b": (14, 2, 64)}
GEMMA_BUDGET = 2048                   # gemma3-27b's QUOKA budget
WHISPER_BUDGET = 512                  # whisper-small's
ARCH_BUDGETS = {"gemma3-27b": GEMMA_BUDGET, "whisper-small": WHISPER_BUDGET}
SWEEP_DIMS = (8, 32, 80, 112, 120)
SWEEP_HEADS = ((4, 4), (6, 2), (14, 2))      # GQA groups 1, 3 and 7


def sweep_pool(torch, np, dev, dtype, d, h, n_kv, g, t, start, bs=128,
               nb=16):
    """A paged pool of 2 * nb + 5 blocks holding two requests' linear views
    in permuted blocks (stale positions elsewhere) and an idle third row
    (table all -1, start 0: no valid key, so exact zeros); plan ids on the
    logical grid.  Returns (q, k_pool, v_pool, pos_pool, ids, starts,
    table)."""
    T, N = nb * bs, 2 * nb + 5
    rng = np.random.default_rng(7 * d + h + g + t)
    gen = torch.Generator(device=dev).manual_seed(d + h)
    q = torch.randn((3, t, h, d), generator=gen, device=dev).to(dtype)
    kp = torch.randn((N, bs, n_kv, d), generator=gen, device=dev).to(dtype)
    vp = torch.randn((N, bs, n_kv, d), generator=gen, device=dev).to(dtype)
    pos = torch.as_tensor(rng.integers(0, T, (N, bs)), dtype=torch.int32,
                          device=dev)
    perm = rng.permutation(N)
    table = np.full((3, nb), -1, np.int32)
    for bi in range(2):
        for lb in range(nb):
            phys = int(perm[bi * nb + lb])
            table[bi, lb] = phys
            p = np.arange(lb * bs, (lb + 1) * bs)
            pos[phys] = torch.as_tensor(np.where(p < start + t, p, -1),
                                        device=dev)
    starts = torch.as_tensor([start, start, 0], dtype=torch.int32,
                             device=dev)
    if g > 1:
        hi = -(-start // g)
        ids = np.full((3, 16), -1, np.int32)
        for bi in range(2):
            ids[bi, :15] = rng.choice(hi, size=15, replace=False)
    else:
        ids = np.full((3, n_kv, 256), -1, np.int32)
        for bi in range(2):
            for hh in range(n_kv):
                ids[bi, hh, :255] = rng.choice(start + 2, size=255,
                                               replace=False)
    return (q, kp, vp, pos, torch.as_tensor(ids, device=dev), starts,
            torch.as_tensor(table, device=dev))


def head_dim_sweep(torch, np, dev, K):
    """Flash, selected and paged attention at head dims off the old 64 /
    128 (8 and 120 padded to the next multiple of 16; 80 and 112 with a
    tail of unswizzled chunks), fp32 and bf16, GQA groups 1, 3 and 7, each
    with a row that has no valid key (exact zeros); paged equal to linear
    bit for bit.  Returns {kernel: max error}."""
    fa, sa, ref = K["flash"], K["selected"], K["ref"]
    errs = {"flash_attention": 0.0, "selected_attention": 0.0,
            "selected_attention_paged": 0.0}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in SWEEP_DIMS:
            for h, n_kv in SWEEP_HEADS:
                gen = torch.Generator(device=dev).manual_seed(d + h)
                for tq, tk, bnd in ((64, 300, 200), (1, 1025, 1024)):
                    q = torch.randn((2, h, tq, d), generator=gen,
                                    device=dev).to(dtype)
                    k = torch.randn((2, n_kv, tk, d), generator=gen,
                                    device=dev).to(dtype)
                    v = torch.randn((2, n_kv, tk, d), generator=gen,
                                    device=dev).to(dtype)
                    valid = torch.rand((2, n_kv, tk), generator=gen,
                                       device=dev) < 0.9
                    valid[1, 0] = False
                    got = fa.flash_attention_bhtd(q, k, v, valid,
                                                  causal=True, boundary=bnd)
                    want = ref.flash_attention_ref(q, k, v, causal=True,
                                                   boundary=bnd,
                                                   k_valid=valid)
                    _sweep_check(torch, "flash", d, h, n_kv, dtype, got,
                                 want, got[1, :h // n_kv], errs,
                                 "flash_attention")
                    n += 1
                for g, t, start in ((16, 64, 1024), (1, 1, 1037)):
                    q, kp, vp, pp, ids, st, tab = sweep_pool(
                        torch, np, dev, dtype, d, h, n_kv, g, t, start)
                    qt = q.transpose(1, 2)
                    paged = sa.selected_attention_paged(
                        qt, kp, vp, pp, ids, st, tab, granularity=g,
                        block_size=kp.shape[1])
                    kl, vl, kpos = ref.linearize_pool(kp, vp, pp, tab)
                    lin = sa.selected_attention_bhtd(
                        qt, kl.transpose(1, 2), vl.transpose(1, 2), kpos,
                        ids, st, granularity=g)
                    want = ref.selected_ref(q, kl, vl, kpos, ids, st,
                                            g).transpose(1, 2)
                    _sweep_check(torch, f"selected g={g}", d, h, n_kv, dtype,
                                 lin, want, lin[2], errs,
                                 "selected_attention")
                    e = max_err(paged, lin)
                    if e != 0.0:
                        raise AssertionError(f"paged != linear at d={d} "
                                             f"h={h}/{n_kv} {dtype}: {e}")
                    errs["selected_attention_paged"] = max(
                        errs["selected_attention_paged"],
                        max_err(paged, want))
                    n += 2
    torch.cuda.synchronize()
    log(f"  head-dim sweep: {n} calls at d {SWEEP_DIMS}, groups 1/3/7, fp32 "
        f"and bf16 within tolerance, no-key rows exact zeros, paged == "
        f"linear bitwise; max errors {errs}")
    return errs


def _sweep_check(torch, name, d, h, n_kv, dtype, got, want, empty, errs,
                 key):
    tol = 2e-5 if dtype == torch.float32 else bf16_ulp(want)
    err = max_err(got, want)
    if not bool(torch.isfinite(got).all()) or not err <= tol:
        raise AssertionError(f"{name} d={d} h={h}/{n_kv} {dtype}: error "
                             f"{err} above {tol}")
    if float(empty.abs().max()) != 0.0:
        raise AssertionError(f"{name} d={d} h={h}/{n_kv} {dtype}: a row "
                             "with no valid key is not exact zeros")
    errs[key] = max(errs[key], err)


def reset_counts(K):
    for m in (K["score"], K["flash"], K["selected"]):
        m.LAUNCHES = 0
    K["selected"].PAGED_LAUNCHES = 0


def read_counts(K):
    return {"quoka_score": K["score"].LAUNCHES,
            "flash_attention": K["flash"].LAUNCHES,
            "selected_attention": K["selected"].LAUNCHES,
            "selected_attention_paged": K["selected"].PAGED_LAUNCHES}


def prompt_batch(np, cfg, positions, b=1, seed=0):
    """A prompt that fills ``positions`` cache positions: token ids and,
    from a numpy seed, whisper's frames (b, n_ctx, d_model) or a VLM's
    patches (b, n, d_in), whose n positions come first (the reference's
    ``dryrun.py`` convention: text = positions - n)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(
        3, cfg.vocab, (b, positions - cfg.prefix_positions)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    elif cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.frontend.n_tokens, cfg.frontend.d_in)).astype(np.float32)
    return batch


def phase_main(torch, np, K, model, label):
    """Phases 3/4: one measured ``Engine.generate`` on the card.  A first
    call warms the signature (kernel build, allocator); the counts are set
    to 0 just before the measured call and read just after it.  The
    prompt fills ``PROMPT`` positions (a VLM's patches among them)."""
    from repro_torch.serving.engine import Engine
    cfg = model.cfg
    batch = prompt_batch(np, cfg, PROMPT)
    eng = Engine(model, method="quoka")
    eng.generate(batch, MAX_NEW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(K)
    r = eng.generate(batch, MAX_NEW)
    counts = read_counts(K)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if r.tokens.shape != (1, MAX_NEW) or r.tokens.min() < 0 or \
            r.tokens.max() >= cfg.vocab:
        raise AssertionError(f"{label}: bad tokens {r.tokens}")
    log(f"  {label}: TTFT {r.ttft_s * 1e3:.1f} ms   decode "
        f"{r.decode_tps:.2f} tok/s   peak memory {peak:.2f} GiB   "
        f"launches {counts}")
    log(f"  {label}: greedy tokens {r.tokens[0].tolist()}")
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


POOL_RANGES = ("pool_gather", "pool_scatter")
# the record_function ranges of the plan's stages and the kernel facade
PLAN_RANGES = ("plan_scores", "plan_materialize", "ops_attention_cuda",
               "ops_selected_attention_cuda", "ops_score_cuda")


def is_annotation(e, extra=()) -> bool:
    """Is this profiler event a range's device-side annotation?  It spans
    its kernels and the gaps between them, so summing it with the kernels
    would count their time twice."""
    return bool(getattr(e, "is_user_annotation", False)) or \
        e.key in POOL_RANGES or e.key in PLAN_RANGES or e.key in extra


def range_device_ms(prof, names):
    """{name: (device ms, calls)} of the ``record_function`` ranges
    ``names``: the summed durations of the kernels launched inside each
    range (its CPU-side event counts its children's kernels; the
    GPU-side annotation of the same name spans the gaps between them
    too, so it is not used)."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.events():
        if e.name in names and e.device_type == DeviceType.CPU:
            ms, n = out.get(e.name, (0.0, 0))
            out[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    return out


class ServeKernelCheck:
    """For the length of one ``with`` block, every call of the facade's
    score and linear selected-attention entries (``kernels/ops.py``)
    launches its kernel as usual and is then held to its plain version on
    the same inputs (the plain runs launch nothing).  The serve state's
    step functions are wrapped too, so each kernel call knows its step's
    block table.  Records, per call: the rows, whether the live rows
    (table not all -1) have distinct starts, whether an idle row (table
    all -1) is in the step, and whether a live row's chunk has a ragged
    tail (pos -1 inside it).  An idle prefill row has no valid key at all
    and must come out as exact zeros."""

    def __init__(self, torch, np, K, state):
        from repro_torch.kernels import ops
        self.torch, self.np, self.ops, self.ref = torch, np, ops, K["ref"]
        self.state = state
        self.table = None
        self.calls = {"quoka_score": [], "selected_attention": []}

    def rows(self, b, dev):
        """(idle, live) bool (b,) of the current step."""
        tab = self.torch.as_tensor(self.table, device=dev)
        if tab.shape[0] != b:
            raise AssertionError(f"kernel batch {b} != step rows "
                                 f"{tab.shape[0]}")
        idle = (tab < 0).all(1)
        return idle, ~idle

    def __enter__(self):
        ops, ref, torch = self.ops, self.ref, self.torch
        self.orig = (ops.quoka_score_bhtd, ops.selected_attention_bhtd,
                     self.state.fns)
        score_k, sel_k, fns = self.orig

        def step_fn(fn):
            def run(data, table, *args, **kw):
                self.table = table
                return fn(data, table, *args, **kw)
            return run

        def score(qbar, k, valid):
            out = score_k(qbar, k, valid)
            want = ref.score_ref(qbar, k, valid)
            idle, live = self.rows(qbar.shape[0], qbar.device)
            n_valid = valid.sum(1)
            self.note("quoka_score", qbar.shape[2], out, want, 1e-4,
                      len(set(n_valid[live].tolist())) > 1,
                      bool(idle.any()), False, qbar.shape[0])
            return out

        def selected(q, k, v, key_pos, block_idx, chunk_start, *,
                     granularity=1, scale=None):
            out = sel_k(q, k, v, key_pos, block_idx, chunk_start,
                        granularity=granularity, scale=scale)
            want = ref.selected_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), key_pos, block_idx,
                                    chunk_start, granularity,
                                    scale).transpose(1, 2)
            b, t = q.shape[0], q.shape[2]
            idle, live = self.rows(b, q.device)
            st = torch.as_tensor(chunk_start, device=q.device).reshape(-1)
            st = st.expand(b).long()
            chunk = torch.gather(key_pos, 1, (st[:, None] + torch.arange(
                t, device=q.device)).clamp(max=key_pos.shape[1] - 1))
            ragged = bool((live & (chunk < 0).any(1)).any())
            empty = (key_pos < 0).all(1)
            if bool(empty.any()) and float(out[empty].abs().max()) != 0.0:
                raise AssertionError("selected_attention: a serve row with "
                                     "no valid key is not exact zeros")
            self.note("selected_attention", t, out, want, bf16_ulp(want),
                      len(set(st[live].tolist())) > 1, bool(idle.any()),
                      ragged, b)
            return out

        ops.quoka_score_bhtd, ops.selected_attention_bhtd = score, selected
        self.state.fns = tuple(step_fn(f) for f in fns)
        return self

    def __exit__(self, *exc):
        (self.ops.quoka_score_bhtd, self.ops.selected_attention_bhtd,
         self.state.fns) = self.orig
        return False

    def note(self, name, t, out, want, tol, distinct, idle, ragged, rows):
        if not bool(self.torch.isfinite(out).all()):
            raise AssertionError(f"{name}: non-finite output on the serve "
                                 f"path")
        err = max_err(out, want)
        if not err <= tol:
            raise AssertionError(f"{name} on the serve path (t={t}, {rows} "
                                 f"rows): error {err} above tolerance {tol}")
        self.calls[name].append(dict(t=t, rows=rows, err=err, tol=tol,
                                     distinct=distinct, idle=idle,
                                     ragged=ragged))

    def report(self):
        """Logs one line per kernel and query width; fails unless each
        kernel met, at both widths, a step with distinct per-row starts and
        an idle row (and, for the prefill width of selected attention, a
        ragged tail).  Returns {kernel: max error}."""
        errs = {}
        for name, calls in self.calls.items():
            widths = sorted({c["t"] for c in calls})
            if len(widths) != 2:
                raise AssertionError(f"{name}: serve widths {widths}, want "
                                     f"a prefill and a decode width")
            for t in widths:
                cs = [c for c in calls if c["t"] == t]
                worst = max(cs, key=lambda c: c["err"] / max(c["tol"],
                                                             1e-30))
                cover = dict(distinct=sum(c["distinct"] and c["idle"]
                                          for c in cs),
                             ragged=sum(c["ragged"] for c in cs))
                check(f"{name} serve t={t} ({len(cs)} calls, "
                      f"{cs[0]['rows']} rows)", worst["err"], worst["tol"],
                      "every call of the run; the worst against its own "
                      "tolerance")
                log(f"    calls with distinct starts and an idle row: "
                    f"{cover['distinct']}; with a ragged tail: "
                    f"{cover['ragged']}")
                need_ragged = name == "selected_attention" and t > 1
                if not cover["distinct"] or (need_ragged
                                             and not cover["ragged"]):
                    raise AssertionError(f"{name} t={t}: the checked serve "
                                         f"run missed a geometry {cover}")
            errs[name] = max(c["err"] for c in calls)
        return errs


def phase_serve(torch, np, K, model):
    """Phase 8: ``Engine.serve`` at full width on the fused route.  The
    state is built first (kernel build and an idle warm-up step, off the
    clocks); the counts are set to 0 just before each trace and read just
    after it.  Returns (state, layer 0's pool leaves, trace 1's tables,
    numbers, {kernel: max error of the checked trace})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request
    cfg = model.cfg
    log("== phase 8: continuous batching, qwen3-4b full width, fused "
        "g=16, paged pool (block 128, prefill 512 tokens/step, 4 decode "
        "rows)")
    rng = np.random.default_rng(8)

    def toks(n):
        return rng.integers(3, cfg.vocab, (n,)).astype(np.int32)

    p1, p2, p3 = toks(8192), toks(3000), toks(1024)
    p4 = np.concatenate([p1[:4096], toks(4096)])
    trace1 = [Request(rid=i, tokens=p, max_new=SERVE_NEW)
              for i, p in enumerate((p1, p2, p3))]
    trace2 = [Request(rid=10, tokens=p4, max_new=SERVE_NEW)]
    # checked: a 4096-token hit (prefill rows start at 4096 beside rows
    # at 0), ragged tails (1000 = 7 x 128 + 104, 600, 300), an idle row
    trace3 = [Request(rid=30, tokens=np.concatenate([p1[:4096], toks(1000)]),
                      max_new=4),
              Request(rid=31, tokens=toks(600), max_new=4),
              Request(rid=32, tokens=toks(300), max_new=4)]
    # profiled: one untraced run, then one of the same shape (fresh
    # tokens: no prefix hit) with the profiler on
    trace4 = [[Request(rid=40 + i, tokens=toks(2048), max_new=8)]
              for i in range(2)]
    eng = Engine(model, method="quoka")
    t0 = time.perf_counter()
    state = eng.make_serve_state(trace1 + trace2, block_size=128,
                                 max_prefill_tokens=512, max_decode_batch=4)
    torch.cuda.synchronize()
    pool = state.pool
    kv0 = pool.data[0][0]
    pool_gib = sum(t.numel() * t.element_size() for st in pool.data
                   for kv in st for t in kv) / 2 ** 30
    log(f"  state: {pool.num_blocks} blocks x {pool.block_size} slots "
        f"({pool_gib:.2f} GiB), {state.max_nb} blocks per request, "
        f"{state.b_prefill} prefill rows, {state.b_decode} decode rows; "
        f"built and warmed in {time.perf_counter() - t0:.1f} s")

    def run(label, trace, n_new):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(K)
        r = eng.serve(trace, state=state)
        counts = read_counts(K)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = r.prefill_steps + r.decode_steps
        want = {"quoka_score": cfg.n_layers * steps, "flash_attention": 0,
                "selected_attention": cfg.n_layers * steps,
                "selected_attention_paged": 0}
        if counts != want:
            raise AssertionError(f"{label} launches {counts} != {want}")
        for q in trace:
            got = r.tokens[q.rid]
            if got.shape != (n_new,) or got.min() < 0 or \
                    got.max() >= cfg.vocab:
                raise AssertionError(f"{label}: bad tokens {got}")
        log(f"  {label}: wall {r.wall_s:.2f} s, {r.generated} tokens, "
            f"{r.tokens_per_s:.2f} tok/s, steps {r.steps} "
            f"({r.prefill_steps} prefill / {r.decode_steps} decode), "
            f"occupancy {r.occupancy:.2f}, peak {peak:.2f} GiB, "
            f"launches {counts}")
        for rid in sorted(r.ttft_s):
            log(f"    request {rid}: prompt "
                f"{len(next(q for q in trace if q.rid == rid).tokens)}, "
                f"cached {r.cached_len[rid]}, TTFT {r.ttft_s[rid]:.3f} s, "
                f"latency {r.latency_s[rid]:.3f} s")
        return r, dict(wall_s=r.wall_s, tokens_per_s=r.tokens_per_s,
                       ttft_s={str(k): v for k, v in r.ttft_s.items()},
                       prefill_steps=r.prefill_steps,
                       decode_steps=r.decode_steps, peak_gib=peak,
                       cached_len={str(k): v
                                   for k, v in r.cached_len.items()})

    out = {}
    for label, trace in (("trace1", trace1), ("trace2", trace2)):
        _, out[label] = run(label, trace, SERVE_NEW)
    if out["trace2"]["cached_len"]["10"] != 4096:
        raise AssertionError(f"trace 2 prefix hit "
                             f"{out['trace2']['cached_len']} != 4096")
    # tables of the first trace: its prompt blocks stay registered
    # (matchable) after the trace, so the prefix index gives them back
    tables = []
    for q in trace1:
        fulls, tail = pool.match_prefix(q.tokens)
        tables.append(fulls + ([tail[0]] if tail else []))
    # every score and selected-attention call of a serve run held to its
    # plain version at the step geometry the serve path gives it (untimed)
    with ServeKernelCheck(torch, np, K, state) as chk:
        r3, _ = run("trace3 (checked)", trace3, 4)
    if r3.cached_len[30] != 4096:
        raise AssertionError(f"trace 3 prefix hit {r3.cached_len} != 4096")
    errs = chk.report()
    # where the serve path's time goes: wall and device busy time both
    # from the profiled window, the untraced wall of the same shape beside
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r4 = eng.serve(trace4[0], state=state)
    torch.cuda.synchronize()
    wall_untraced = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve(trace4[1], state=state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side kernel, copy and memset events; the ranges' GPU-side
    # annotations would count their kernels twice
    dev_ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0 and not is_annotation(e)]
    busy = sum(e.self_device_time_total for e in dev_ev) / 1e3
    rng_ms = range_device_ms(prof, POOL_RANGES)
    steps = r4.prefill_steps + r4.decode_steps
    idle = 1 - busy / (wall * 1e3)
    log(f"  trace4 (prompt 2048, 8 new, prefix hit {r4.cached_len[40]}, "
        f"{r4.prefill_steps} prefill / {r4.decode_steps} decode steps): "
        f"profiled wall {wall * 1e3:.1f} ms over {steps} step-function "
        f"calls, device busy {busy:.1f} ms in it, idle share {idle:.3f}; "
        f"untraced wall {wall_untraced * 1e3:.1f} ms")
    for e in sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms  {e.count:5d} "
            f"calls  {e.key[:90]}")
    for name, (ms, n) in sorted(rng_ms.items()):
        log(f"    {name}: {ms:.2f} ms device in {n} calls "
            f"({ms / max(n, 1):.3f} ms per call)")
    out["trace4"] = dict(wall_ms=wall * 1e3, busy_ms=busy, steps=steps,
                         idle_share=idle,
                         wall_untraced_ms=wall_untraced * 1e3,
                         cached_len=r4.cached_len[40],
                         **{k: dict(device_ms=v[0], calls=v[1])
                            for k, v in rng_ms.items()})
    return state, kv0, tables, out, errs


HOLE, STALE = 10, 11        # logical blocks of phase 9's fourth row


def paged_inputs(torch, np, state, kv0, tables, t, starts, g):
    """Phase-9 inputs on the serve pool: layer 0's leaves and five rows —
    the first trace's three tables (-1 padded); a fourth row, the first
    row's table with a -1 hole at logical block ``HOLE`` and logical block
    ``STALE`` mapped to a recycled (free) block holding stale positions
    >= its start; an idle fifth row (table all -1, start 0).  The other
    free blocks hold stale positions >= 0 below the start.  Per-row
    ``starts``; random chunk queries; plan ids built by ``plan.build`` on
    the gathered view, then one id of the fourth row forced into the hole
    and one into the stale block (no plan picks them: the view reads the
    hole as pos -1 and the stale block as not yet prior context)."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.serving import pool as pl
    pool = state.pool
    dev = kv0.k.device
    bs = pool.block_size
    nb = state.max_nb
    tab = np.full((5, nb), -1, np.int32)
    for i, blocks in enumerate(tables):
        tab[i, :len(blocks)] = blocks
    tab[3] = tab[0]
    tab[3, HOLE] = -1
    free = list(pool._free)
    tab[3, STALE] = free[0]
    pos = kv0.pos.clone()
    gen = torch.Generator(device=dev).manual_seed(90 + t)
    top = max(starts)
    pos[torch.as_tensor(free[1:], device=dev)] = torch.randint(
        0, max(top, 1), (len(free) - 1, bs), generator=gen, device=dev,
        dtype=torch.int32)
    pos[free[0]] = torch.randint(starts[3], starts[3] + 4096, (bs,),
                                 generator=gen, device=dev,
                                 dtype=torch.int32)
    view = pl.gather([[kv0._replace(pos=pos)]], tab, pool.num_blocks,
                     bs)[0][0]
    cfg = pool.model.cfg
    q = torch.randn((5, t, cfg.n_heads, kv0.k.shape[-1]), generator=gen,
                    device=dev).to(kv0.k.dtype)
    qcfg = dataclasses.replace(cfg.quoka, granularity=g,
                               fused_select_attn=g > 1)
    st = torch.as_tensor(starts, dtype=torch.int32, device=dev)
    idx = plan_mod.build("quoka", q, view.k, view.pos, st, qcfg,
                         budget=1024).idx
    if g > 1:
        idx[3, 0], idx[3, 1] = HOLE * bs // g, STALE * bs // g
    else:
        idx[3, :, 0], idx[3, :, 1] = HOLE * bs + 5, STALE * bs + 7
    return q, pos, torch.as_tensor(tab, device=dev), idx, st, view


TEL_BLOCK, TEL_NEW = 128, 8          # phase 32's pool block and new tokens


def phase_telemetry(torch, np, K, model, card):
    """Phase 32: serve-path telemetry on phase 8's fused qwen3-4b (module
    docstring).  Each engine gets a fresh pool of the same geometry, so
    all see the same prefix cache and ``Engine.stats`` can be equal; a
    priming request registers the 4096-token prefix first, and the counts
    are set to 0 just before the measured trace and read just after it.
    Returns the numbers."""
    from repro_torch import obs
    from repro_torch.core import plan as plan_mod
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request
    cfg = model.cfg
    layers = cfg.n_layers
    log(f"== phase 32: serve-path telemetry, qwen3-4b full width, fused "
        f"g={cfg.quoka.granularity}, registry on and off")
    rng = np.random.default_rng(32)

    def toks(n):
        return rng.integers(3, cfg.vocab, (n,)).astype(np.int32)

    base, tail0, tail1, fresh = toks(4096), toks(128), toks(256), \
        (toks(600), toks(300))

    def requests():
        prime = [Request(rid=0, tokens=np.concatenate([base, tail0]),
                         max_new=4)]
        trace = [Request(rid=1, tokens=np.concatenate([base, tail1]),
                         max_new=TEL_NEW)] + \
            [Request(rid=2 + i, tokens=p, max_new=TEL_NEW)
             for i, p in enumerate(fresh)]
        return prime, trace

    # on, off, off, on: the ratio is the two "on" walls over the two
    # "off" walls, which cancels a drift of the host's speed over the runs
    runs = []
    layer_steps = [0]

    def checked(note):
        """``Engine._note_layer_obs`` that first holds every selecting
        layer of the step to its budget, kv_fraction <= budget_fraction +
        1e-6, on the host copy the engine already made.  A step whose view
        holds no prior context yet (the priming request's first chunk) has
        no fraction; otherwise every layer has one."""
        def note_and_check(phase, rows):
            sel, ctx, bud = rows[0], rows[1], rows[2]
            with np.errstate(invalid="ignore", divide="ignore"):
                frac, budf = sel / ctx, bud / ctx
            on = np.isfinite(frac) & np.isfinite(budf)
            over = on & ~(frac <= budf + 1e-6)
            if over.any() or int(on.sum()) not in (0, layers):
                raise AssertionError(
                    f"phase 32 {phase} step: kv_fraction {frac} against "
                    f"budget fraction {budf}: {int(over.sum())} layers "
                    f"over, {int(on.sum())} of {layers} with a fraction")
            layer_steps[0] += int(on.sum())
            note(phase, rows)
        return note_and_check

    for label in ("on", "off", "off", "on"):
        reg = obs.Registry() if label == "on" else None
        eng = Engine(model, method="quoka", registry=reg)
        if reg is not None:
            eng._note_layer_obs = checked(eng._note_layer_obs)
        prime, trace = requests()
        state = eng.make_serve_state(prime + trace, block_size=TEL_BLOCK,
                                     max_prefill_tokens=512,
                                     max_decode_batch=4)
        r0 = eng.serve(prime, state=state)
        torch.cuda.synchronize()
        reset_counts(K)
        t0 = time.perf_counter()
        r1 = eng.serve(trace, state=state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(K)
        steps = r1.prefill_steps + r1.decode_steps
        want = {"quoka_score": layers * steps, "flash_attention": 0,
                "selected_attention": layers * steps,
                "selected_attention_paged": 0}
        if counts != want:
            raise AssertionError(f"phase 32 {label}: launches {counts} != "
                                 f"{want}")
        if r1.cached_len[1] != 4096:
            raise AssertionError(f"phase 32 {label}: prefix hit "
                                 f"{r1.cached_len} != 4096")
        runs.append(dict(label=label, reg=reg, res=(r0, r1), wall=wall,
                         counts=counts, stats=dict(eng.stats),
                         consts=len(plan_mod._CONST)))
        log(f"  registry {label}: wall {wall * 1e3:.1f} ms for {steps} step "
            f"calls ({r1.prefill_steps} prefill / {r1.decode_steps} "
            f"decode), {r1.generated} tokens, launches {counts}")
        del eng, state
        torch.cuda.empty_cache()
    on = runs[0]
    for other in runs[1:]:
        for a, b in zip(on["res"], other["res"]):
            for rid in b.tokens:
                if not np.array_equal(a.tokens[rid], b.tokens[rid]):
                    raise AssertionError(
                        f"phase 32: request {rid} tokens {a.tokens[rid]} "
                        f"(on) vs {b.tokens[rid]} ({other['label']})")
        if on["counts"] != other["counts"] or on["stats"] != other["stats"]:
            raise AssertionError(f"phase 32: runs differ: {on['counts']} "
                                 f"{other['counts']} {on['stats']} "
                                 f"{other['stats']}")
    # telemetry's cached constants: made in the first registry-on run,
    # none added by the second
    if runs[3]["consts"] != runs[0]["consts"]:
        raise AssertionError(f"phase 32: telemetry constants grew "
                             f"{runs[0]['consts']} -> {runs[3]['consts']}")
    wall_on = sum(r["wall"] for r in runs if r["label"] == "on")
    wall_off = sum(r["wall"] for r in runs if r["label"] == "off")
    reg, res = on["reg"], on["res"]
    c = {k: v.value for k, v in reg.counters.items()}
    g = {k: v.value for k, v in reg.gauges.items()}
    calls = sum(r.prefill_steps + r.decode_steps for r in res)
    if c.get("select/plan_refresh") != layers * calls:
        raise AssertionError(f"phase 32: plan_refresh "
                             f"{c.get('select/plan_refresh')} != "
                             f"{layers} x {calls}")
    if layer_steps[0] < 2 * layers * (res[1].prefill_steps
                                      + res[1].decode_steps):
        raise AssertionError(f"phase 32: only {layer_steps[0]} layer-steps "
                             f"held to their budget")
    kv = [f"select/layer{i:02d}/kv_fraction" for i in range(layers)]
    for k in kv:
        bud = g.get(k.replace("kv_fraction", "budget_fraction"))
        if k not in g or bud is None or not g[k] <= bud + 1e-6:
            raise AssertionError(f"phase 32: {k} {g.get(k)} over its "
                                 f"budget fraction {bud}")
    sched_want = {
        "sched/submitted": sum(len(r.tokens) for r in res),
        "sched/admitted": sum(len(r.tokens) for r in res),
        "sched/finished": sum(len(r.tokens) for r in res),
        "sched/prefix_hit_requests": sum(
            sum(1 for v in r.cached_len.values() if v) for r in res),
        "sched/prefix_hit_tokens": sum(sum(r.cached_len.values())
                                       for r in res),
        "sched/preemptions": sum(r.preemptions for r in res),
        "sched/resumes": sum(r.resumes for r in res),
        "serve/tokens_generated": sum(r.generated for r in res)}
    got = {k: c.get(k, 0.0) for k in sched_want}
    if got != {k: float(v) for k, v in sched_want.items()}:
        raise AssertionError(f"phase 32: counters {got} != {sched_want}")
    with tempfile.TemporaryDirectory() as tmp:
        paths = obs.export_all(reg, tmp, prefix="phase32")
        with open(paths["trace"]) as f:
            n_ev = len(json.load(f)["traceEvents"])
        with open(paths["jsonl"]) as f:
            n_lines = sum(1 for _ in f)
    hist = reg.histograms["select/kv_fraction"].summary()
    ratio = wall_on / wall_off
    spans = {k: reg.histograms[k].summary() for k in
             ("engine/prefill_step", "engine/decode_step")}
    log(f"  tokens, launches and stats equal on and off; plan_refresh "
        f"{c['select/plan_refresh']:.0f} = {layers} x {calls}; every layer's "
        f"kv_fraction within its budget fraction at every step "
        f"({layer_steps[0]} layer-steps, both registry-on runs); "
        f"{runs[0]['consts']} telemetry constants, none added by the second "
        f"registry-on run; sched counters equal "
        f"the ServeResult fields; Chrome trace {n_ev} events, JSONL "
        f"{n_lines} lines")
    log(f"  wall registry on / off {ratio:.4f} ({wall_on * 1e3:.1f} / "
        f"{wall_off * 1e3:.1f} ms, two runs each); selected-KV fraction "
        f"mean {hist['mean']:.4f} (min {hist['min']:.4f}, max "
        f"{hist['max']:.4f}, {hist['count']} layer-steps) at budget {cfg.quoka.budget}; step "
        f"spans p50 prefill {spans['engine/prefill_step']['p50'] * 1e3:.1f} "
        f"ms, decode {spans['engine/decode_step']['p50'] * 1e3:.1f} ms "
        f"[{card}]")
    step_cost = obs_step_cost(torch, np, K, model, rng, card)
    small = obs_card_vs_cpu(torch, np)
    return dict(wall_ms={f"{i} {r['label']}": r["wall"] * 1e3
                         for i, r in enumerate(runs)},
                ratio=ratio, kv_fraction=hist, plan_refresh=c[
                    "select/plan_refresh"], step_calls=calls,
                launches=on["counts"], spans_s=spans,
                layer_steps_checked=layer_steps[0], step_cost=step_cost,
                trace_events=n_ev, small=small, card=card)


def obs_step_cost(torch, np, K, model, rng, card):
    """What ``with_obs`` costs one full-width decode step of phase 32's
    model (one row, 1280 tokens of context, so every layer selects): the
    kernel launches of one step with it off and on, counted as the
    runtime's launch calls in a CPU-activity ``torch.profiler`` trace, and
    the step's host wall (``perf_counter`` around the step and a
    synchronize), the median of three each, off and on interleaved."""
    cfg = model.cfg
    t, n_chunks = cfg.quoka.chunk_size, 10
    ctx = n_chunks * t
    cache = model.init_cache(1, ctx + 32)
    ids = rng.integers(3, cfg.vocab, (1, ctx)).astype(np.int32)
    for c in range(n_chunks):
        model.prefill_chunk({"tokens": ids[:, c * t:(c + 1) * t]}, c * t,
                            cache)
    tok = torch.tensor([5], device=model.device)
    pos = [ctx]
    reset_counts(K)

    def step(with_obs):
        model.decode_step(tok, pos[0], cache, with_obs=with_obs)
        pos[0] += 1

    launches, walls = {}, {False: [], True: []}
    for with_obs in (False, True):
        step(with_obs)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            step(with_obs)
            torch.cuda.synchronize()
        launches[with_obs] = sum(
            1 for e in prof.events()
            if e.name.startswith(("cudaLaunch", "cuLaunch")))
    for _ in range(3):
        for with_obs in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(with_obs)
            torch.cuda.synchronize()
            walls[with_obs].append(time.perf_counter() - t0)
    off_ms, on_ms = (float(np.median(walls[w])) * 1e3 for w in (False, True))
    n_steps = pos[0] - ctx
    got = read_counts(K)
    if got["quoka_score"] != cfg.n_layers * n_steps or \
            got["selected_attention"] != cfg.n_layers * n_steps:
        raise AssertionError(f"phase 32: {n_steps} decode steps launched "
                             f"{got}, not every layer selecting")
    extra = launches[True] - launches[False]
    log(f"  one decode step (1 row, {ctx} tokens of context): kernel "
        f"launches {launches[False]} off / {launches[True]} on ({extra} "
        f"more, {extra / cfg.n_layers:.1f} per layer call); host wall "
        f"{off_ms:.2f} / {on_ms:.2f} ms (median of 3) [{card}]")
    return dict(launches_off=launches[False], launches_on=launches[True],
                wall_ms_off=off_ms, wall_ms_on=on_ms)


def obs_card_vs_cpu(torch, np):
    """Phase 32's second half: ``tests/test_torch_cuda.py``'s
    ``layer_obs_card_vs_cpu`` (a smoke-size fp32 qwen3-4b, the same
    weights on both devices, reuse interval 2, staged and fused at g = 16:
    the ``LayerObs`` of four prefill chunks and two decode steps, card
    against CPU), its sketch error held to 2e-5 here."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_cuda import layer_obs_card_vs_cpu
    out = {}
    for route, label in (("staged", "staged g=1"), ("fused", "fused g=16")):
        err, calls, n_nan = layer_obs_card_vs_cpu(
            torch.device("cuda", torch.cuda.current_device()), route)
        check(f"LayerObs sketch card vs CPU, {label}", err, 2e-5,
              "fp32 scores, summation order differs")
        log(f"  LayerObs card == CPU, {label}: {calls} calls, counts exact, "
            f"{n_nan} NaN sketches in the same places")
        out[label] = dict(sketch_err=err, calls=calls, nan_sketches=n_nan)
    return out


def phase_paged(torch, np, K, state, kv0, tables):
    """Phase 9: the paged kernel on the pool the serve path filled, driven
    through its entry point ``ops.selected_attention(table=)`` (the counts
    set to 0 just before and read just after), then held to its plain
    version and, bit for bit, to the linear kernel on the gathered view.
    Returns (max error against the plain version, launches, the first
    case's inputs)."""
    from repro_torch.kernels import ops
    sa, ref = K["selected"], K["ref"]
    log("== phase 9: paged selected attention on the serve pool (layer 0)")
    prefill = [4096, 2944, 896, 4096, 0]      # 2944: ragged tail at 3016
    decode = [8200, 2990, 1020, 8200, 0]      # 8200: past row 0's blocks
    cases = ((16, 128, prefill), (16, 1, decode), (1, 128, prefill),
             (1, 1, decode))
    inputs = [paged_inputs(torch, np, state, kv0, tables, t, starts, g)
              for g, t, starts in cases]
    for q, pos, tab, idx, st, view in inputs[:1]:
        p3 = view.pos[3].reshape(-1, state.pool.block_size)
        if int(p3[HOLE].max()) != -1 or int(p3[STALE].min()) < int(st[3]):
            raise AssertionError("phase 9: hole / stale block not in place")
    torch.cuda.synchronize()
    reset_counts(K)
    bs = state.pool.block_size
    outs = [ops.selected_attention(q, kv0.k, kv0.v, pos, idx, st,
                                   granularity=g, table=tab, block_size=bs)
            for (g, _, _), (q, pos, tab, idx, st, _) in zip(cases, inputs)]
    torch.cuda.synchronize()
    counts = read_counts(K)
    want = {"quoka_score": 0, "flash_attention": 0, "selected_attention": 0,
            "selected_attention_paged": len(cases)}
    if counts != want:
        raise AssertionError(f"phase 9 launches {counts} != {want}")
    e = 0.0
    for (g, t, starts), (q, pos, tab, idx, st, view), out in zip(
            cases, inputs, outs):
        got = out.transpose(1, 2)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("selected_attention_paged: non-finite")
        if float(got[4].abs().max()) != 0.0:
            raise AssertionError("selected_attention_paged: idle row not "
                                 "exact zeros")
        qt = q.transpose(1, 2)
        want = ref.selected_paged_ref(q, kv0.k, kv0.v, pos, idx, st,
                                      tab, g).transpose(1, 2)
        lin = sa.selected_attention_bhtd(qt, view.k.transpose(1, 2),
                                         view.v.transpose(1, 2), view.pos,
                                         idx, st, granularity=g)
        err = max_err(got, want)
        check(f"paged g={g} t={t} starts {starts[:3]} ids "
              f"{tuple(idx.shape)}", err, bf16_ulp(want),
              "1 bf16 ulp of the output: fp32 sums, one rounding each")
        check(f"paged vs linear kernel on the view, g={g} t={t}",
              max_err(got, lin), 0.0, "bitwise: the same tile reads the "
              "same rows in the same order")
        e = max(e, err)
    return e, counts["selected_attention_paged"], inputs[0]


def phase_small_serve(torch, np):
    """Phase 10: a smoke-size fp32 model serves one trace on the card and
    on the CPU (same weights): the greedy tokens equal each other and each
    request's own ``generate`` on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, build_model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import make_requests
    log("== phase 10: small serve, card (kernels) vs CPU (plain versions)")
    base = get_config("qwen3-4b").smoke()
    rng = np.random.default_rng(10)
    prompts = [rng.integers(3, base.vocab, (n,)).astype(np.int32)
               for n in (48, 16, 64, 32)]
    kw = dict(block_size=16, max_decode_batch=3, max_prefill_tokens=32)
    for label, method, qover in (
            ("full", "full", {}), ("staged g=1", "quoka", {}),
            ("fused g=16", "quoka", {"granularity": 16,
                                     "fused_select_attn": True})):
        cfg = dataclasses.replace(base, quoka=dataclasses.replace(
            base.quoka, **qover))
        cpu = build_model(cfg, device="cpu", seed=2)
        gpu = Model(cfg)
        gpu.load_state_dict(cpu.state_dict())
        tc = Engine(cpu, method=method, device="cpu").serve(
            make_requests(prompts, 6), **kw).tokens
        eg = Engine(gpu, method=method)
        tg = eg.serve(make_requests(prompts, 6), **kw).tokens
        for i, pr in enumerate(prompts):
            one = eg.generate({"tokens": pr[None]}, 6).tokens[0]
            if not (np.array_equal(tc[i], tg[i])
                    and np.array_equal(tg[i], one)):
                raise AssertionError(f"serve tokens differ, {label}, "
                                     f"request {i}: CPU {tc[i]}, card "
                                     f"{tg[i]}, generate {one}")
        log(f"  serve tokens equal on card, CPU and per-request generate, "
            f"{label}")


BASELINES = ("sample_attention", "sparq", "loki", "less_is_more", "snapkv",
             "keydiff")
METHOD_PROMPT, METHOD_NEW = 4096, 8          # phase 11
METHOD_LAYERS = 12                           # phase 11's cut of 36 layers
REUSE = dict(reuse_interval=4, correction_layers=(0, METHOD_LAYERS - 1))


def method_runs():
    """Phase 11's runs: (label, method, QuokaConfig overrides)."""
    runs = [(m, m, {}) for m in ("full", "quoka") + BASELINES]
    runs += [(f"quoka reuse 4, corrections {REUSE['correction_layers']}",
              "quoka", REUSE),
             ("quoka score_proj_dim 32", "quoka", {"score_proj_dim": 32})]
    runs += [(f"{m} fused g=16", m, {"granularity": 16,
                                     "fused_select_attn": True})
             for m in ("sample_attention", "keydiff")]
    return runs


def expected_launches(cfg, method, qover, steps):
    """Exact launch counts of one ``generate`` whose every prefill chunk and
    decode step selects (``steps`` of them per layer): the dense bypass
    (``full``) launches nothing; scoring runs for QUOKA only, on every
    layer that refreshes its plan; attention on every layer, through the
    flash kernel (staged) or the selected kernel (fused)."""
    want = {"quoka_score": 0, "flash_attention": 0, "selected_attention": 0,
            "selected_attention_paged": 0}
    if method == "full":
        return want
    q = dataclasses.replace(cfg.quoka, **qover)
    s = max(1, q.reuse_interval)
    refresh = [li for li in range(cfg.n_layers)
               if li % s == 0 or li in q.correction_layers]
    if method == "quoka":
        want["quoka_score"] = len(refresh) * steps
    key = "selected_attention" if q.fused_select_attn else "flash_attention"
    want[key] = cfg.n_layers * steps
    return want


def phase_methods(torch, np, K, model, card):
    """Phase 11: every selection method through ``Engine.generate`` at
    qwen3-4b full width (``model`` cut to ``METHOD_LAYERS`` layers), prompt
    4096, 8 new tokens, batch 1.  Each run: a
    first ``generate`` warms its signature, then the counts are set to 0
    just before the measured one and read just after; they must equal
    ``expected_launches``."""
    from repro_torch.serving.engine import Engine
    cfg = model.cfg
    log(f"== phase 11: every method, qwen3-4b full width, "
        f"{cfg.n_layers} layers, prompt {METHOD_PROMPT}, {METHOD_NEW} new "
        f"tokens, batch 1 [{card}]")
    toks = np.random.default_rng(11).integers(
        3, cfg.vocab, (1, METHOD_PROMPT)).astype(np.int32)
    steps = METHOD_PROMPT // cfg.quoka.chunk_size + METHOD_NEW - 1
    out = {}
    for label, method, qover in method_runs():
        model.cfg = dataclasses.replace(cfg, quoka=dataclasses.replace(
            cfg.quoka, **qover))
        eng = Engine(model, method=method)
        eng.generate({"tokens": toks}, METHOD_NEW)
        torch.cuda.synchronize()
        reset_counts(K)
        r = eng.generate({"tokens": toks}, METHOD_NEW)
        counts = read_counts(K)
        want = expected_launches(cfg, method, qover, steps)
        if counts != want:
            raise AssertionError(f"phase 11 {label}: launches {counts} != "
                                 f"{want}")
        if r.tokens.shape != (1, METHOD_NEW) or r.tokens.min() < 0 or \
                r.tokens.max() >= cfg.vocab:
            raise AssertionError(f"phase 11 {label}: bad tokens {r.tokens}")
        log(f"  {label}: TTFT {r.ttft_s * 1e3:.1f} ms, decode "
            f"{r.decode_tps:.2f} tok/s, launches {counts} [{card}]")
        log(f"    greedy tokens {r.tokens[0].tolist()}")
        out[label] = dict(ttft_s=r.ttft_s, decode_tok_s=r.decode_tps,
                          tokens=r.tokens[0].tolist(), launches=counts)
    model.cfg = cfg
    return out


def harness_cfgs(**kw):
    """(route, QuokaConfig) for the harness: staged g = 1 and fused g = 16."""
    from repro_torch.configs.base import QuokaConfig
    base = QuokaConfig(**kw)
    return (("staged", base),
            ("fused", dataclasses.replace(base, granularity=16,
                                          fused_select_attn=True)))


HARNESS_SHAPE = (1, 8192, 32, 8, 128)        # phase 12: b, T, h, n_kv, d
HARNESS_BUDGET = 1024


def phase_harness(torch, np, K, card, dev):
    """Phase 12: the model-free chunked-prefill harness on the card.

    (a) The paper's accuracy proxies at qwen3-4b's attention geometry:
        the port's ``structured_qkv`` (seed 0) at b = 1, T = 8192, h = 32,
        n_kv = 8, d = 128 in bf16, chunk 128, budget 1024, N_Q 16; every
        method, staged and fused.  The dense oracle's (1, 32, 8192, 8192)
        fp32 logits would take 8 GiB; ``dense_causal_reference`` streams
        them in 1024-key blocks (1 GiB each).
    (b) budget >= T: the harness equals the dense oracle within 1 bf16 ulp
        of the output (phase 2's attention tolerance).
    (c) the reference test's small size (b = 2, T = 512, h = 8, n_kv = 2,
        d = 64; chunk 128, budget 64) in fp32 and bf16: the card's harness
        equals the CPU's for every method, with flash (staged) or selected
        (fused) launches on every chunk, and QUOKA's key recall beats
        SampleAttention's."""
    from repro_torch.core import chunked_prefill as cp
    from repro_torch.data.synthetic import structured_qkv
    log(f"== phase 12: chunked-prefill harness on the card [{card}]")
    T = HARNESS_SHAPE[1]
    q, k, v = (x.to(torch.bfloat16) for x in
               structured_qkv(0, *HARNESS_SHAPE, device=dev))
    # keys that get >= 0.08 of some last-chunk query's softmax: the
    # critical recall's denominator (0 keys: that recall is 0 by definition)
    n_crit = int(cp.critical_keys(q, k, harness_cfgs(chunk_size=128)[0][1])
                 .sum())
    log(f"  T={T}: {n_crit} critical keys (tau 0.08) in the last chunk's "
        f"prior context")
    out = {"proxies": {}, "critical_keys": n_crit}
    t0 = time.perf_counter()
    for route, qcfg in harness_cfgs(chunk_size=128, budget=HARNESS_BUDGET,
                                    n_queries=16):
        for m in ("full", "quoka") + BASELINES:
            if m == "full" and route == "fused":
                continue
            row = {"output_error": float(cp.output_error(q, k, v, qcfg, m))}
            if m != "full":
                row["key_recall"] = float(cp.key_recall(q, k, v, qcfg, m))
                row["critical_key_recall"] = float(
                    cp.critical_key_recall(q, k, v, qcfg, m))
            log(f"  T={T} {route:6s} {m:16s} " + "  ".join(
                f"{n} {x:.4f}" for n, x in row.items()) + f"  [{card}]")
            out["proxies"][f"{route} {m}"] = row
    log(f"  (proxies in {time.perf_counter() - t0:.1f} s)")
    dense = cp.dense_causal_reference(q, k, v)
    for route, qcfg in harness_cfgs(chunk_size=128, budget=T, n_queries=16):
        got = cp.chunked_sparse_attention(q, k, v, qcfg, "quoka")
        check(f"harness T={T} budget=T {route} vs dense", max_err(got, dense),
              bf16_ulp(dense), "1 bf16 ulp of the output")
    del q, k, v, dense
    torch.cuda.empty_cache()
    small = list(structured_qkv(3, 2, 512, 8, 2, 64))
    for dtype in (torch.float32, torch.bfloat16):
        cpu = [x.to(dtype) for x in small]
        card_in = [x.to(dev) for x in cpu]
        for route, qcfg in harness_cfgs(chunk_size=128, budget=64,
                                        n_queries=16):
            for m in ("full", "quoka") + BASELINES:
                reset_counts(K)
                got = cp.chunked_sparse_attention(*card_in, qcfg, m)
                torch.cuda.synchronize()
                counts = read_counts(K)
                want = cp.chunked_sparse_attention(*cpu, qcfg, m)
                tol = 2e-5 if dtype == torch.float32 else bf16_ulp(want)
                err = max_err(got.cpu(), want)
                if not err <= tol:
                    raise AssertionError(f"harness card vs CPU {route} {m} "
                                         f"{dtype}: error {err} > {tol}")
                attn = counts["selected_attention" if route == "fused"
                              else "flash_attention"]
                if (m == "full") != (attn == 0):
                    raise AssertionError(f"harness {route} {m}: launches "
                                         f"{counts}")
                if m != "full":
                    for fn in (cp.key_recall, cp.critical_key_recall):
                        a = float(fn(*card_in, qcfg, m))
                        b = float(fn(*cpu, qcfg, m))
                        if a != b:
                            raise AssertionError(
                                f"{fn.__name__} {route} {m} {dtype}: card "
                                f"{a} != CPU {b}")
            log(f"  small size {str(dtype)[6:]} {route}: card == CPU for "
                f"every method (outputs, key recall, critical recall)")
    _, qcfg = harness_cfgs(chunk_size=128, budget=64, n_queries=16)[0]
    card_in = [x.to(dev) for x in small]
    r_q = float(cp.key_recall(*card_in, qcfg, "quoka"))
    r_s = float(cp.key_recall(*card_in, qcfg, "sample_attention"))
    log(f"  small size key recall: quoka {r_q:.4f}, sample_attention "
        f"{r_s:.4f}")
    if not r_q > r_s:
        raise AssertionError(f"QUOKA's key recall {r_q} does not beat "
                             f"SampleAttention's {r_s}")
    out["small_recall"] = {"quoka": r_q, "sample_attention": r_s}
    return out


def phase_small_baselines(torch, np):
    """Phase 13: every baseline serves a smoke-size fp32 model on the card
    and on the CPU (same weights, two requests): equal greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, build_model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import make_requests
    log("== phase 13: small serve per baseline, card vs CPU")
    cfg = get_config("qwen3-4b").smoke()
    rng = np.random.default_rng(13)
    prompts = [rng.integers(3, cfg.vocab, (n,)).astype(np.int32)
               for n in (64, 48)]
    kw = dict(block_size=16, max_decode_batch=2, max_prefill_tokens=32)
    cpu = build_model(cfg, device="cpu", seed=3)
    gpu = Model(cfg)
    gpu.load_state_dict(cpu.state_dict())
    for m in BASELINES:
        tc = Engine(cpu, method=m, device="cpu").serve(
            make_requests(prompts, 6), **kw).tokens
        tg = Engine(gpu, method=m).serve(make_requests(prompts, 6),
                                         **kw).tokens
        for i in range(len(prompts)):
            if not np.array_equal(tc[i], tg[i]):
                raise AssertionError(f"serve tokens differ, {m}, request "
                                     f"{i}: CPU {tc[i]}, card {tg[i]}")
        log(f"  {m}: serve tokens equal on card and CPU")


def oneshot_launches(cfg, text):
    """Exact launches of one ``generate`` (``text`` prompt tokens, MAX_NEW)
    on ``cfg``'s
    route: a layer selects at a chunk or decode step when its cache (a
    ring of min(cap, window) slots for ``attn_local``) exceeds budget + t
    (else it takes the dense bypass: no kernel); a selecting layer launches
    scoring once, then flash (staged) or selected attention (fused), except
    a windowed layer, which attends [selected | chunk] on the plain masked
    path (as the reference).  A recurrent layer (``mamba``, ``rwkv``) has
    no KV cache and launches nothing; a ``mamba_shared_attn`` layer's
    shared attention block launches as an ``attn`` layer, and so does a
    ``dec_cross`` layer's self-attention (whisper's encoder and
    cross-attention launch nothing).  The cache holds the prompt's tokens
    and the frontend's positions before them (a VLM's patches), so a
    prompt of ``text`` tokens prefills ``text + cfg.prefix_positions``
    positions in chunks."""
    from repro_torch.core.plan import resolve_budget
    q = cfg.quoka
    positions = text + cfg.prefix_positions
    cap = positions + MAX_NEW
    if q.granularity > 1:
        cap = -(-cap // q.granularity) * q.granularity
    chunk = q.chunk_size
    score = attn = 0
    for kind in cfg.layer_kinds():
        if kind in ("mamba", "rwkv"):
            continue
        c = min(cap, cfg.sliding_window) if kind == "attn_local" else cap
        bud = resolve_budget(q, c)
        n = (positions // chunk) * (c > bud + chunk) + \
            (MAX_NEW - 1) * (c > bud + 1)
        score += n
        attn += 0 if kind == "attn_local" else n
    # fused_route's test on a full-length cache view (cap is on the grid)
    fused = q.fused_select_attn and q.granularity > 1
    return {"quoka_score": score, "flash_attention": 0 if fused else attn,
            "selected_attention": attn if fused else 0,
            "selected_attention_paged": 0}


ROUTES = (("staged", {}),
          ("fused", dict(granularity=16, fused_select_attn=True)))


GEMMA_LAYERS = 12        # phase 22's cut: two periods of 5 local + 1 global
# phases 14-16's cuts in depth (of 28 and 32 layers), for the run's time
# limit: the whole run took 1225 s on a slow host before them
LLAMA_LAYERS = STABLELM_LAYERS = 4


def phase_oneshot(torch, np, K, arch, phase, routes=ROUTES, layers=None):
    """Phases 14 (llama3-2-3b), 15 (stablelm-3b), 20 (h2o-danube-3-4b) and
    22 (gemma3-27b): ``Engine.generate`` at the published width from
    random weights (seed 0), staged then g = 16 with the fused route on,
    with exact launch counts (``oneshot_launches``): on a dense model one
    score and one attention launch per layer per chunk and per decode
    step; gemma3-27b's local layers (a 1024-slot ring, within budget 2048
    + chunk) take the dense bypass, so only its global layers launch
    (it, llama3-2-3b and stablelm-3b run cut in depth to ``layers``);
    h2o-danube-3-4b's windowed layers launch scoring only.  Also phases 23
    (zamba2-7b), 24 (rwkv6-1.6b, ``routes`` staged only: it has no KV
    cache, so no route selects), 26 (whisper-small: its decoder's
    self-attention launches; a prompt of 8192 tokens over 1500 frames)
    and 27 (internvl2-1b: 7936 tokens after 256 patches, 8192 positions).
    Returns (the model, on the last route, and its numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(arch)
    depth = cfg.n_layers
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    win = f", window {cfg.sliding_window}" if cfg.sliding_window else ""
    front = cfg.prefix_positions
    text = PROMPT - front               # the tokens ``prompt_batch`` draws
    prompt = f"{text} tokens + {front} patches" if front else f"{PROMPT}"
    if cfg.encoder is not None:
        prompt += (f" over {cfg.encoder.n_ctx} frames ({cfg.encoder.n_layers}"
                   f"-layer encoder)")
    log(f"== phase {phase}: {arch} one-shot at full width ({cfg.n_layers} "
        f"of {depth} layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, d {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}{win}, budget {cfg.quoka.budget}, bf16), prompt "
        f"{prompt}, {MAX_NEW} new")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"  weights drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB)")
    out = {}
    for route, qover in routes:
        model.cfg = dataclasses.replace(cfg, quoka=dataclasses.replace(
            cfg.quoka, **qover))
        r, counts, peak = phase_main(torch, np, K, model, f"{arch} {route}")
        if r.prompt_len != text:
            raise AssertionError(f"{arch} {route} prompt {r.prompt_len} "
                                 f"!= {text} tokens")
        want = oneshot_launches(model.cfg, text)
        if counts != want:
            raise AssertionError(f"{arch} {route} launches {counts} != "
                                 f"{want}")
        out[route] = dict(ttft_s=r.ttft_s, decode_tok_s=r.decode_tps,
                          peak_gib=peak, launches=counts,
                          tokens=r.tokens[0].tolist())
    return model, out


HT_PROMPT, HT_NEW = 6144, 16                  # phase 16


def phase_host_tier(torch, np, K, model):
    """Phase 16: the host-memory tier on llama3-2-3b ``serve``, fused g=16:
    a 64-block device pool (block 128) with a 128-block host tier,
    prefetch depth 4, one decode row.  A (6144 tokens) is served, then B
    (6144 other tokens), whose pressure demotes most of A; then [B, A]: A
    waits behind B, its host blocks are staged during B's steps and
    promoted at A's admission.  The same traces on a 256-block pool with
    no tier and each request's own ``generate`` give the same greedy
    tokens; one of A's blocks is held byte for byte through demotion and
    promotion; a ``torch.profiler`` trace of [B, A] shows every H2D copy of
    a slab from pinned memory, on a stream other than the compute stream,
    inside the device span of one step (between the step's first and last
    compute kernels, no token fetch in between), and counts the copies
    that overlap a compute kernel itself."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.pool import _chain_hashes, _slab_leaves
    from repro_torch.serving.request import Request
    cfg = model.cfg
    L = cfg.n_layers
    log(f"== phase 16: host tier, llama3-2-3b ({L} layers) serve, fused "
        "g=16 (block 128, device pool 64 blocks, host tier 128 blocks, "
        "prefetch depth 4, one prefill and one decode row)")
    rng = np.random.default_rng(16)
    a = rng.integers(3, cfg.vocab, (HT_PROMPT,)).astype(np.int32)
    b = rng.integers(3, cfg.vocab, (HT_PROMPT,)).astype(np.int32)

    def trace(*ps):
        return [Request(rid=rid, tokens=p, max_new=HT_NEW) for rid, p in ps]

    eng = Engine(model, method="quoka")
    # one prefill row and one decode row: every product has generate's
    # shape, so bf16 rounds alike and the tokens can be held to it
    kw = dict(block_size=128, max_decode_batch=1, max_prefill_tokens=128)
    t0 = time.perf_counter()
    tier = eng.make_serve_state(trace((1, a), (2, b)), num_blocks=64,
                                host_tier_blocks=128, prefetch_depth=4, **kw)
    pool = tier.pool
    if not pool.host.store.is_pinned():
        raise AssertionError("host tier rows are not pinned")
    slab = pool.host.store.shape[1]
    log(f"  tier state: {pool.num_blocks} device blocks, host tier "
        f"{pool.host.capacity} pinned slabs of {slab / 2 ** 20:.2f} MiB "
        f"({pool.host.capacity * slab / 2 ** 30:.2f} GiB), built and warmed "
        f"in {time.perf_counter() - t0:.1f} s")

    def run(state, label, ps):
        torch.cuda.synchronize()
        reset_counts(K)
        r = eng.serve(trace(*ps), state=state)
        counts = read_counts(K)
        steps = r.prefill_steps + r.decode_steps
        want = {"quoka_score": L * steps, "flash_attention": 0,
                "selected_attention": L * steps,
                "selected_attention_paged": 0}
        if counts != want:
            raise AssertionError(f"phase 16 {label} launches {counts} != "
                                 f"{want}")
        st = dict(eng.stats)
        log(f"  {label}: wall {r.wall_s:.2f} s, steps {r.steps} "
            f"({r.prefill_steps} prefill / {r.decode_steps} decode), "
            f"cached {r.cached_len}, TTFT "
            f"{ {k: round(v, 4) for k, v in r.ttft_s.items()} } s, "
            f"launches {counts}; pool {st}")
        return r, st

    def packed(blk):
        return torch.cat([leaf[blk].reshape(-1).view(torch.uint8)
                          for leaf in _slab_leaves(pool.data)]).cpu()

    h0 = _chain_hashes(a, pool.block_size)[0]
    r_a, _ = run(tier, "A cold", [(1, a)])
    snap = packed(pool._full[h0])
    r_b, s_b = run(tier, "B (pressure on A's blocks)", [(2, b)])
    if s_b["demoted"] < 1 or h0 not in pool._h_full:
        raise AssertionError(f"B did not demote A's first block: {s_b}")
    slot = pool._h_full[h0]
    pool.host.written[slot].synchronize()
    if not torch.equal(pool.host.row(slot), snap):
        raise AssertionError("a demoted slab differs from its device block")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tier.json")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            r_ba, s_ba = run(tier, "[B, A] (A promoted)", [(2, b), (1, a)])
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    if s_ba["promoted"] < 1 or s_ba["staged_used"] < 1 or \
            s_b["demoted"] < 1:
        raise AssertionError(f"tier not exercised: {s_ba}")
    if not torch.equal(packed(pool._full[h0]), snap):
        raise AssertionError("a promoted block differs from its slab")
    pool.check_invariants()
    # every H2D copy of a slab in the trace of [B, A]
    kern = [e for e in events if e.get("cat") == "kernel"]
    streams = {}
    for e in kern:
        streams[e["args"]["stream"]] = streams.get(e["args"]["stream"], 0) + 1
    compute = max(streams, key=streams.get)
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")
              and e.get("args", {}).get("bytes") == slab]
    if not copies:
        raise AssertionError("no slab H2D copy in the trace")
    on_compute = sorted((k["ts"], k["ts"] + k["dur"]) for k in kern
                        if k["args"]["stream"] == compute)
    starts = [k[0] for k in on_compute]
    # a step ends with its one fetch of the tokens (device -> pageable)
    fetches = sorted(e["ts"] for e in events
                     if e.get("cat") == "gpu_memcpy"
                     and "DtoH" in e.get("name", "")
                     and "Pageable" in e["name"]
                     and e["args"]["stream"] == compute)
    direct = 0
    for e in copies:
        if "Pinned" not in e["name"] or "Pageable" in e["name"]:
            raise AssertionError(f"slab copy not from pinned memory: "
                                 f"{e['name']}")
        if e["args"]["stream"] == compute:
            raise AssertionError("slab copy on the compute stream")
        lo, hi = e["ts"], e["ts"] + e["dur"]
        # the step it runs in: between two fetches, inside the span of
        # that step's compute kernels
        f = bisect.bisect_left(fetches, lo)
        f0 = fetches[f - 1] if f > 0 else -math.inf
        f1 = fetches[f] if f < len(fetches) else math.inf
        i = bisect.bisect_left(starts, hi) - 1
        step = [k for k in on_compute[bisect.bisect_right(starts, f0):
                                      bisect.bisect_left(starts, f1)]]
        if f1 < hi or not step or step[0][0] > lo or \
                max(k[1] for k in step) < hi:
            raise AssertionError(f"slab copy [{lo}, {hi}] not inside one "
                                 f"step's compute span")
        direct += i >= 0 and on_compute[i][1] > lo
    h2d_ms = sum(e["dur"] for e in copies) / 1e3
    gbps = len(copies) * slab / (h2d_ms * 1e-3) / 1e9
    log(f"  trace of [B, A]: {len(copies)} slab H2D copies, all "
        f"{copies[0]['name']}, on stream(s) "
        f"{sorted({e['args']['stream'] for e in copies})} (compute stream "
        f"{compute}), each inside the compute span of one step; {direct} "
        f"of them overlap a compute kernel, the rest fall in the step's "
        f"host gaps; {h2d_ms:.2f} ms of copies, {gbps:.1f} GB/s")
    # the same traces on a 256-block pool with no tier, and generate
    big = eng.make_serve_state(trace((1, a), (2, b)), num_blocks=256,
                               host_tier_blocks=0, **kw)
    g_a, _ = run(big, "no tier, 256 blocks: A", [(1, a)])
    g_b, _ = run(big, "no tier, 256 blocks: B", [(2, b)])
    g_ba, _ = run(big, "no tier, 256 blocks: [B, A]", [(2, b), (1, a)])
    gen = {rid: eng.generate({"tokens": p[None]}, HT_NEW).tokens[0]
           for rid, p in ((1, a), (2, b))}
    for label, rt, rn in (("A", r_a, g_a), ("B", r_b, g_b),
                          ("[B, A]", r_ba, g_ba)):
        for rid, toks in rt.tokens.items():
            if not (np.array_equal(toks, rn.tokens[rid])
                    and np.array_equal(toks, gen[rid])):
                raise AssertionError(
                    f"phase 16 {label} request {rid}: tier {toks}, no tier "
                    f"{rn.tokens[rid]}, generate {gen[rid]}")
    cold = r_a.ttft_s[1]
    promoted = r_ba.ttft_s[1] - r_ba.latency_s[2]
    dev_hit = g_ba.ttft_s[1] - g_ba.latency_s[2]
    log(f"  greedy tokens equal: tier == no tier == generate, every trace")
    log(f"  A's TTFT: cold {cold:.4f} s | promoted from the host tier "
        f"{promoted:.4f} s (from B's completion; {s_ba['promoted']:.0f} "
        f"blocks promoted, {s_ba['staged_used']:.0f} from staging) | device "
        f"hit, no tier {dev_hit:.4f} s")
    return dict(ttft_cold_s=cold, ttft_promoted_s=promoted,
                ttft_device_hit_s=dev_hit, demoted=s_b["demoted"],
                promoted=s_ba["promoted"], staged_used=s_ba["staged_used"],
                host_evictions=s_ba["host_evictions"],
                slab_bytes=slab, h2d_copies=len(copies),
                h2d_copies_on_a_kernel=direct, h2d_ms=h2d_ms,
                h2d_gb_per_s=gbps, wall_s={"A": r_a.wall_s, "B": r_b.wall_s,
                                           "BA": r_ba.wall_s})


OLMOE_NEW = 16                                  # phase 17's serve


def phase_olmoe(torch, np, K):
    """Phase 17: olmoe-1b-7b (16 layers, d_model 2048, MHA 16 / 16, d 128,
    64 experts top-8, d_expert 1024, capacity dispatch) at full width from
    random weights: one-shot staged and fused (``phase_oneshot``), one MoE
    layer's capacity dispatch on the card against the same plain code on
    the CPU, and a continuous serve of three requests.  Returns the
    one-shot numbers and the rest."""
    model, oneshot = phase_oneshot(torch, np, K, "olmoe-1b-7b", 17)
    out = {"capacity": moe_capacity_check(torch, np, model)}
    out["serve"] = olmoe_serve(torch, np, K, model)
    out["trace"] = phase_trace(torch, np, model, phase="  phase 17")
    del model
    torch.cuda.empty_cache()
    return oneshot, out


def moe_capacity_check(torch, np, model):
    """Layer 0's MoE in fp32 on one 128-token chunk (capacity 20 slots per
    expert), on the card and on the CPU: the router's experts and the
    dropped (token, choice) pairs identical, outputs within 1e-4
    relative."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(model.cfg, dtype=torch.float32)
    layer = model.layers()[0].moe
    cpu = moe.MoE(cfg, "cpu")
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in layer.state_dict().items()})
    gpu = moe.MoE(cfg, model.device)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(17)
    x = torch.randn((1, cfg.quoka.chunk_size, cfg.d_model), generator=gen)
    want = moe.moe_apply(cpu, x, cfg)
    got = moe.moe_apply(gpu, x.to(model.device), cfg).cpu()
    xf = x.reshape(-1, cfg.d_model)
    cap = moe.capacity(cfg.moe, xf.shape[0])
    _, ids_c, _ = moe.route(cpu, xf, cfg.moe)
    _, ids_g, _ = moe.route(gpu, xf.to(model.device), cfg.moe)
    if not torch.equal(ids_g.cpu(), ids_c):
        raise AssertionError("phase 17: the router's experts differ on the "
                             "card")
    drop_c = ~moe.capacity_slots(ids_c, cfg.moe.n_experts, cap)[2]
    drop_g = ~moe.capacity_slots(ids_g, cfg.moe.n_experts, cap)[2].cpu()
    if not torch.equal(drop_g, drop_c):
        raise AssertionError("phase 17: the dropped pairs differ on the "
                             "card")
    rel = max_err(got, want) / float(want.abs().max())
    check("olmoe layer 0 capacity dispatch, card vs CPU (fp32, relative)",
          rel, 1e-4, "fp32 products, summation order differs")
    log(f"  capacity {cap} slots per expert; {int(drop_c.sum())} of "
        f"{drop_c.numel()} (token, choice) pairs dropped, the same set on "
        f"the card and the CPU")
    return dict(capacity=cap, dropped=int(drop_c.sum()),
                pairs=drop_c.numel(), rel_err=rel)


def olmoe_serve(torch, np, K, model):
    """Phase 17's serve: three requests (8192, 3000 and 2048 tokens, 16 new
    each) on the fused route, block 128, one prefill row and one decode
    row, so every MoE call's batch has ``generate``'s shape and N (the
    capacity depends on N).  A request must equal its own ``generate``
    where that runs the same computation: the whole-chunk prompts (8192
    and 2048 tokens, both above budget + chunk - 16, so ``generate``
    selects too).  The 3000-token one only reports its first differing
    token: ``generate`` left-pads it where the serve step packs a ragged
    tail (another chunking), as in the reference."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request
    cfg = model.cfg
    L = cfg.n_layers
    rng = np.random.default_rng(17)
    prompts = {i: rng.integers(3, cfg.vocab, (n,)).astype(np.int32)
               for i, n in enumerate((8192, 3000, 2048))}
    trace = [Request(rid=i, tokens=p, max_new=OLMOE_NEW)
             for i, p in prompts.items()]
    log("  serve: 8192, 3000 and 2048 tokens, 16 new each, fused g=16, "
        "block 128, one prefill and one decode row")
    eng = Engine(model, method="quoka")
    state = eng.make_serve_state(trace, block_size=128, max_decode_batch=1,
                                 max_prefill_tokens=128)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(K)
    r = eng.serve(trace, state=state)
    counts = read_counts(K)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = r.prefill_steps + r.decode_steps
    want = {"quoka_score": L * steps, "flash_attention": 0,
            "selected_attention": L * steps, "selected_attention_paged": 0}
    if counts != want:
        raise AssertionError(f"phase 17 serve launches {counts} != {want}")
    log(f"  serve: wall {r.wall_s:.2f} s, {r.generated} tokens, "
        f"{r.tokens_per_s:.2f} tok/s, steps {r.steps} ({r.prefill_steps} "
        f"prefill / {r.decode_steps} decode), peak {peak:.2f} GiB, "
        f"launches {counts}, TTFT "
        f"{ {k: round(v, 3) for k, v in r.ttft_s.items()} } s")
    first_diff = {}
    for rid, p in prompts.items():
        got = r.tokens[rid]
        gen = eng.generate(eng.pad_prompt(p[None]), OLMOE_NEW).tokens[0]
        if got.shape != (OLMOE_NEW,) or got.min() < 0 or \
                got.max() >= cfg.vocab:
            raise AssertionError(f"phase 17 serve: bad tokens {got}")
        diff = np.flatnonzero(got != gen)
        first_diff[rid] = int(diff[0]) if diff.size else None
        qc = cfg.quoka
        why = "another chunking" if len(p) % qc.chunk_size else None
        if why is None and diff.size:
            raise AssertionError(f"phase 17 serve request {rid} (prompt "
                                 f"{len(p)}): tokens {got} != generate's "
                                 f"{gen}")
        log(f"    request {rid}, prompt {len(p)}: "
            + ("tokens equal generate's" if not diff.size else
               f"first token differing from generate's at step "
               f"{first_diff[rid]} ({why}, reported only)"))
    return dict(wall_s=r.wall_s, tokens_per_s=r.tokens_per_s,
                steps=r.steps, peak_gib=peak, launches=counts,
                ttft_s=r.ttft_s, first_diff_vs_generate=first_diff)


DEEPSEEK_LAYERS = ((("mla",), 3), (("mla_moe",), 1))   # phase 18's cut


def phase_deepseek(torch, np, K):
    """Phase 18: deepseek-v3's published attention and expert geometry
    (d_model 7168, 128 heads, q_lora 1536, latent 512 + rope 64, 256
    experts top-8 plus one shared, d_expert 2048, vocab 129280, untied,
    MTP held) cut in depth to its 3 dense MLA layers and 1 MoE layer, from
    random weights: one-shot staged (MLA's only route) with exact launch
    counts, then layer 0's selected attention on the card against its
    plain version on the call's own inputs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=4,
                              layer_groups=DEEPSEEK_LAYERS)
    log(f"== phase 18: deepseek-v3 attention geometry, 4 layers (3 mla + 1 "
        f"mla_moe; published 61), d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, latent {cfg.mla.kv_lora_rank} + {cfg.mla.qk_rope_dim}, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, bf16, prompt "
        f"{PROMPT}, {MAX_NEW} new")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"  weights drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB)")
    per_run = cfg.n_layers * (PROMPT // cfg.quoka.chunk_size + MAX_NEW - 1)
    r, counts, peak = phase_main(torch, np, K, model, "deepseek-v3 staged")
    want = {"quoka_score": per_run, "flash_attention": per_run,
            "selected_attention": 0, "selected_attention_paged": 0}
    if counts != want:
        raise AssertionError(f"deepseek-v3 staged launches {counts} != "
                             f"{want}")
    # layer 0's flash call at the chunk after a 2048-token prefill
    pre, chunk = PROMPT // 4, cfg.quoka.chunk_size
    toks = np.random.default_rng(18).integers(
        3, cfg.vocab, (1, pre + chunk)).astype(np.int32)
    cache = model.init_cache(1, PROMPT + MAX_NEW)
    model.prefill({"tokens": toks[:, :pre]}, cache)
    calls = []
    kernel = ops.attention

    def recording(*a, **kw):
        calls.append((a, kw))
        return kernel(*a, **kw)
    ops.attention = recording
    model.prefill_chunk({"tokens": toks[:, pre:]}, pre, cache)
    ops.attention = kernel
    (q, k, v, valid), kw = calls[0]
    got = kernel(q, k, v, valid, **kw)
    want_o = K["ref"].flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        k_valid=valid, **kw).transpose(1, 2)
    check(f"deepseek-v3 layer 0 selected attention q {tuple(q.shape)} k "
          f"{tuple(k.shape)} v {tuple(v.shape)}, card vs plain",
          max_err(got, want_o), bf16_ulp(want_o), "1 bf16 ulp of the output")
    blk = model.layers()[0]
    out, out_p = blk._decompress(got, q.dtype), blk._decompress(want_o,
                                                                q.dtype)
    rel = max_err(out, out_p) / float(out_p.float().abs().max())
    log(f"  layer 0's block output after W_uv, kernel vs plain flash: "
        f"{rel:.2e} relative")
    res = dict(ttft_s=r.ttft_s, decode_tok_s=r.decode_tps, peak_gib=peak,
               launches=counts, tokens=r.tokens[0].tolist(),
               layer0_rel_err=rel,
               trace=phase_trace(torch, np, model, phase="  phase 18"))
    del cache
    return res, model


DS_NEW = 16                                    # phase 19's new tokens


def phase_deepseek_serve(torch, np, K, model):
    """Phase 19: phase 18's deepseek-v3 (4 layers) served over the paged
    pool with the host tier, staged (MLA's only route): every layer's
    latent cache in pool blocks (block 128, a 72-block device pool, 128
    pinned host slabs, prefetch depth 4, one prefill and one decode row).
    A (8192 tokens) cold; B, A's first 4096 tokens then 4096 others (a
    4096-token prefix hit; its fresh blocks demote A's tail to the host
    tier); then [C (2048 tokens), A]: C's blocks demote more of A, A waits
    behind C (too few device blocks for both), its host blocks staged during
    C's steps and promoted at its admission.  Exact launch counts (one
    score and one flash launch per layer per step); every request's greedy
    tokens equal its own ``generate``; every slab of A is held byte for
    byte through demotion (the host row) and promotion (the device block).
    The last prefill and decode flash calls of A's cold serve (layer 3)
    are held to the plain version and timed beside SDPA (phase 6's row
    form).  Returns (numbers, {"d576_serve": row, "d576_serve_decode":
    row})."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.pool import _chain_hashes, _slab_leaves
    from repro_torch.serving.request import Request
    cfg = model.cfg
    L = cfg.n_layers
    log("== phase 19: deepseek-v3 (4 layers) serve over the paged pool and "
        "the host tier, staged (block 128, device pool 72 blocks, host tier "
        "128 blocks, prefetch depth 4, one prefill and one decode row)")
    rng = np.random.default_rng(19)
    a = rng.integers(3, cfg.vocab, (PROMPT,)).astype(np.int32)
    b = np.concatenate([a[:PROMPT // 2], rng.integers(
        3, cfg.vocab, (PROMPT // 2,)).astype(np.int32)])
    c = rng.integers(3, cfg.vocab, (2048,)).astype(np.int32)
    prompts = {1: a, 2: b, 3: c}

    def trace(*rids):
        return [Request(rid=rid, tokens=prompts[rid], max_new=DS_NEW)
                for rid in rids]

    eng = Engine(model, method="quoka")
    t0 = time.perf_counter()
    state = eng.make_serve_state(trace(1, 2, 3), block_size=128,
                                 num_blocks=72, host_tier_blocks=128,
                                 prefetch_depth=4, max_decode_batch=1,
                                 max_prefill_tokens=128)
    pool = state.pool
    if not pool.host.store.is_pinned():
        raise AssertionError("host tier rows are not pinned")
    slab = pool.host.store.shape[1]
    log(f"  pool: {pool.num_blocks} device blocks of latent caches "
        f"({L} layers x 128 slots x {cfg.mla.kv_lora_rank} + "
        f"{cfg.mla.qk_rope_dim}), host tier {pool.host.capacity} pinned "
        f"slabs of {slab / 2 ** 20:.3f} MiB, {state.max_nb} blocks per "
        f"request; built and warmed in {time.perf_counter() - t0:.1f} s")
    # the flash calls of A's cold serve: the last with a chunk of queries
    # and the last of a decode step (each replaces the one before)
    seen = {}
    kernel = ops.attention

    def recording(*args, **kw):
        seen["prefill" if args[0].shape[1] > 1 else "decode"] = (args, kw)
        return kernel(*args, **kw)

    totals = dict.fromkeys(read_counts(K), 0)

    def run(label, *rids, record=False):
        torch.cuda.synchronize()
        reset_counts(K)
        if record:
            ops.attention = recording
        try:
            r = eng.serve(trace(*rids), state=state)
        finally:
            ops.attention = kernel
        counts = read_counts(K)
        steps = r.prefill_steps + r.decode_steps
        want = {"quoka_score": L * steps, "flash_attention": L * steps,
                "selected_attention": 0, "selected_attention_paged": 0}
        if counts != want:
            raise AssertionError(f"phase 19 {label} launches {counts} != "
                                 f"{want}")
        for name, n in counts.items():
            totals[name] += n
        st = dict(eng.stats)
        log(f"  {label}: wall {r.wall_s:.2f} s, steps {r.steps} "
            f"({r.prefill_steps} prefill / {r.decode_steps} decode), "
            f"cached {r.cached_len}, TTFT "
            f"{ {k: round(v, 4) for k, v in r.ttft_s.items()} } s, "
            f"launches {counts}; pool {st}")
        return r, st

    def packed(blk):
        return torch.cat([leaf[blk].reshape(-1).view(torch.uint8)
                          for leaf in _slab_leaves(pool.data)])

    chain = _chain_hashes(a, pool.block_size)
    r_a, _ = run("A cold", 1, record=True)
    # these calls have the shapes of phase 6's d576 rows
    rows = {}
    junk = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=model.device)
    for what, key in (("prefill", "d576_serve"),
                      ("decode", "d576_serve_decode")):
        (q, k, v, valid), kw = seen[what]
        B = kw["boundary"]
        rows[key] = mla_flash_row(
            torch, K, lambda: junk.fill_(1), q.transpose(1, 2),
            k.transpose(1, 2), v.transpose(1, 2), valid, B,
            f"serve {what} (layer {L - 1}, A's last)")
    del junk
    snap = {h: packed(pool._full[h]) for h in chain}
    r_b, s_b = run("B (A's first 4096 tokens, then 4096 others)", 2)
    if r_b.cached_len[2] != PROMPT // 2:
        raise AssertionError(f"B's prefix hit {r_b.cached_len[2]} != "
                             f"{PROMPT // 2}")
    demoted = [h for h in chain if h in pool._h_full]
    if s_b["demoted"] < 1 or not demoted:
        raise AssertionError(f"B demoted none of A's blocks: {s_b}")
    for h in demoted:
        slot = pool._h_full[h]
        pool.host.written[slot].synchronize()
        if not torch.equal(pool.host.row(slot), snap[h].cpu()):
            raise AssertionError("a demoted latent slab differs from its "
                                 "device block")
    r_ca, s_ca = run("[C, A] (A promoted)", 3, 1)
    if s_ca["promoted"] < 1:
        raise AssertionError(f"A promoted nothing: {s_ca}")
    for h in chain:
        if not torch.equal(packed(pool._full[h]), snap[h]):
            raise AssertionError("a promoted latent block differs from its "
                                 "slab")
    pool.check_invariants()
    log(f"  latent slabs byte-exact: {len(demoted)} of A's {len(chain)} "
        f"blocks on the host after B, all {len(chain)} back on the device "
        f"after [C, A] ({s_ca['promoted']:.0f} promoted, "
        f"{s_ca['staged_used']:.0f} from staging)")
    gen = {rid: eng.generate({"tokens": p[None]}, DS_NEW).tokens[0]
           for rid, p in prompts.items()}
    for label, r in (("A", r_a), ("B", r_b), ("[C, A]", r_ca)):
        for rid, toks in r.tokens.items():
            if not np.array_equal(toks, gen[rid]):
                raise AssertionError(f"phase 19 {label} request {rid}: "
                                     f"serve {toks}, generate {gen[rid]}")
    log("  greedy tokens equal: serve == generate, every request and trace")
    promoted_ttft = r_ca.ttft_s[1] - r_ca.latency_s[3]
    return dict(ttft_s={"A cold": r_a.ttft_s[1], "B hit": r_b.ttft_s[2],
                        "C": r_ca.ttft_s[3],
                        "A promoted (from C's completion)": promoted_ttft},
                wall_s={"A": r_a.wall_s, "B": r_b.wall_s,
                        "CA": r_ca.wall_s},
                demoted=s_b["demoted"] + s_ca["demoted"],
                promoted=s_ca["promoted"], staged_used=s_ca["staged_used"],
                host_evictions=s_b["host_evictions"]
                + s_ca["host_evictions"], slab_bytes=slab,
                steps={"A": r_a.steps, "B": r_b.steps, "CA": r_ca.steps},
                launches=totals), rows


def phase_window_small(torch, np):
    """Phase 21: gemma3-27b's and h2o-danube-3-4b's smoke configs (window
    64, budget 32, chunk 16) in fp32, same weights on the card (kernels)
    and on the CPU (plain versions), at prompt 160 > the window, so every
    ring wraps: staged and g = 16 with the fused route on; prefill logits
    within 1e-4 and greedy tokens equal."""
    log("== phase 21: sliding-window smoke models, card (kernels) vs CPU "
        "(plain versions), prompt 160 > window 64")
    small_card_vs_cpu(torch, np, ("gemma3-27b", "h2o-danube-3-4b"), ROUTES,
                      seed=21)


def small_card_vs_cpu(torch, np, archs, routes, seed):
    """Phases 21, 25 and 28: each smoke config of ``archs`` in fp32 on each
    route, the same weights on the card and on the CPU, at 160 positions
    (whisper: 160 tokens over 64 frames; a VLM: 16 patches + 144 tokens):
    prefill logits within 1e-4 and ``generate``'s greedy tokens equal."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, build_model
    from repro_torch.serving.engine import Engine
    for arch in archs:
        base = get_config(arch).smoke()
        toks = prompt_batch(np, base, 160, b=2, seed=seed)
        for label, qover in routes:
            cfg = dataclasses.replace(base, quoka=dataclasses.replace(
                base.quoka, **qover))
            cpu = build_model(cfg, device="cpu", seed=1)
            gpu = Model(cfg)
            gpu.load_state_dict(cpu.state_dict())
            lc, _ = cpu.prefill(toks, cpu.init_cache(2, 176))
            lg, _ = gpu.prefill(toks, gpu.init_cache(2, 176))
            check(f"{arch} smoke prefill logits, {label}",
                  max_err(lg.cpu(), lc), 1e-4,
                  "fp32 everywhere, summation order differs")
            tc = Engine(cpu, device="cpu").generate(toks, 8).tokens
            tg = Engine(gpu).generate(toks, 8).tokens
            if not np.array_equal(tc, tg):
                raise AssertionError(f"{arch} smoke greedy tokens differ, "
                                     f"{label}: {tc} vs {tg}")
            log(f"  {arch} smoke greedy tokens equal, {label}")


TRACE_CHUNKS = 4         # prefill chunks a trace times and profiles


def phase_trace(torch, np, model, prompt=2048, steps=8, phase="== phase 7",
                spans=None, frontend=None, patches=None):
    """Phase 7 (and the traces of phases 17-18, 20 and 22-24): where the
    time of the model's route goes.  A chunked prefill of ``prompt`` tokens
    and ``steps`` decode steps: the prefill's last ``TRACE_CHUNKS`` chunks
    (a full cache behind them) and the decode steps are each timed without
    the profiler (host clock around synchronize) and traced once with
    ``torch.profiler`` for the device time by kernel (the profiler's cost
    grows with the ops it records, so the earlier chunks run untraced).
    Device idle share = 1 - device busy time / untraced wall time.
    ``spans`` ({label: (owner, attribute)}) wraps those functions in
    ``record_function`` ranges for the traced run only, and reports each
    range's device time, with the products' (every GEMM kernel's).
    ``frontend(cache)`` (whisper: the encoder and the cross-attention
    keys) runs before the untraced chunks and again at the head of the
    timed and traced ones, so the trace holds one prefill's frontend work
    beside its last chunks.  A VLM's ``patches`` (1, n, d_in) take the
    prompt's first n positions: the untraced chunks and the traced ones
    each embed the whole prompt as ``Model.prefill`` does
    (``embed_inputs``: the projector, its output ahead of the tokens'
    embeddings) and run the stacks on their chunks of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    bcp = model.cfg.quoka.chunk_size
    n_chunks = prompt // bcp
    k0 = n_chunks - TRACE_CHUNKS
    n_front = 0 if patches is None else patches.shape[1]
    what = f"{prompt - n_front} tokens after {n_front} patches" if n_front \
        else f"{prompt} tokens"
    log(f"{phase}: trace, {model.cfg.name} prefill of {what} "
        f"({n_chunks} chunks, the last {TRACE_CHUNKS} timed and traced) + "
        f"{steps} decode steps")
    toks = np.random.default_rng(7).integers(
        3, model.cfg.vocab, (1, prompt - n_front)).astype(np.int32)
    g = model.cfg.quoka.granularity     # a block plan's cap is on its grid
    cap = -(-(prompt + steps) // g) * g

    def chunks(cache, lo, hi):
        if patches is None:
            for c in range(lo, hi):
                last, cache = model.prefill_chunk(
                    {"tokens": toks[:, c * bcp:(c + 1) * bcp]}, c * bcp,
                    cache)
            return last, cache
        x, pos = model.embed_inputs({"tokens": toks, "patches": patches})
        ctx = model._ctx(model.cfg.quoka.method)
        for c in range(lo, hi):
            s = slice(c * bcp, (c + 1) * bcp)
            h, _, _ = model._apply_stacks(x[:, s], pos[:, s], cache,
                                          dict(ctx, slot=c * bcp))
        return h[:, -1], cache

    def prefix():
        cache = model.init_cache(1, cap)
        if frontend is not None:
            frontend(cache)
        chunks(cache, 0, k0)
        return cache

    def prefill(cache):
        if frontend is not None:
            frontend(cache)
        last, cache = chunks(cache, k0, n_chunks)
        return model._readout(last[:, None])[:, 0].argmax(-1), cache

    def decode(tok, cache):
        for i in range(steps):
            lg, cache = model.decode_step(tok, prompt + i, cache)
            tok = lg.argmax(-1)
        return tok

    def busy_us(prof):
        # device-side events only (kernels, memcpy, memset): the CPU ops
        # that launched them carry the same time and would count it twice,
        # and a span's device-side annotation covers its kernels again
        total, by_name = 0.0, {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or \
                    is_annotation(e, spans or {}):
                continue
            us = e.self_device_time_total
            if us > 0:
                total += us
                by_name[e.key] = (us, e.count)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        score = [sum(v[i] for k, v in by_name.items() if SCORE_KERNELS[0] in k)
                 for i in (0, 1)]
        attn = [sum(v[i] for k, v in by_name.items()
                    if any(a in k for a in ATTN_KERNELS)) for i in (0, 1)]
        return total, top, score, attn

    out = {}
    tok, cache = prefill(prefix())             # warm
    decode(tok, cache)
    for label in ("prefill", "decode"):
        if label == "prefill":
            cache = prefix()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if label == "prefill":
            tok, cache = prefill(cache)
        else:
            decode(tok, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if label == "prefill":
            cache = prefix()
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                traced_spans(torch, spans or {}):
            if label == "prefill":
                tok, cache = prefill(cache)
            else:
                decode(tok, cache)
            torch.cuda.synchronize()
        busy, top, (score_us, score_n), (attn_us, attn_n) = busy_us(prof)
        idle = 1.0 - busy * 1e-6 / wall
        # host work: torch ops issued per layer call (outermost aten ops)
        n_ops = sum(1 for e in prof.events() if e.name.startswith("aten::")
                    and (e.cpu_parent is None
                         or not e.cpu_parent.name.startswith("aten::")))
        calls = model.cfg.n_layers * (
            TRACE_CHUNKS if label == "prefill" else steps)
        log(f"  {label}: wall {wall * 1e3:.1f} ms untraced, device busy "
            f"{busy / 1e3:.1f} ms, idle share {idle:.3f}, "
            f"{n_ops / calls:.0f} torch ops per layer call")
        for name, (us, n) in top:
            log(f"    {us / 1e3:9.2f} ms  {n:5d} calls  {name[:90]}")
        log(f"    scoring: {score_us / 1e3:.2f} ms device in {score_n} calls "
            f"({score_us / max(score_n, 1) / 1e3:.4f} ms per call); "
            f"attention kernels (main + merge): {attn_us / 1e3:.2f} ms in "
            f"{attn_n} launches")
        out[label] = dict(wall_ms=wall * 1e3, busy_ms=busy / 1e3,
                          idle_share=idle, ops_per_layer_call=n_ops / calls,
                          score_ms=score_us / 1e3, score_calls=score_n,
                          attn_kernel_ms=attn_us / 1e3,
                          attn_kernel_launches=attn_n,
                          top=[[nm[:90], us / 1e3, n]
                               for nm, (us, n) in top])
        if spans:
            got = range_device_ms(prof, set(spans))
            gemm = [(e.self_device_time_total, e.count)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not is_annotation(e, spans)
                    and any(w in e.key.lower() for w in (
                        "gemm", "gemv", "cutlass", "xmma", "nvjet"))]
            got["products (GEMM kernels)"] = (
                sum(us for us, _ in gemm) / 1e3, sum(n for _, n in gemm))
            for name, (ms, n) in got.items():
                log(f"    span {name}: {ms:.2f} ms device in {n} calls")
            out[label]["spans_ms"] = {k: v[0] for k, v in got.items()}
    return out


class traced_spans:
    """For one ``with`` block, each ``spans`` entry {label: (owner,
    attribute)} runs inside a ``record_function(label)`` range (the owner
    is a module or a class; module globals are looked up at call time)."""

    def __init__(self, torch, spans):
        self.torch, self.spans, self.saved = torch, spans, {}

    def __enter__(self):
        for label, (owner, attr) in self.spans.items():
            fn = getattr(owner, attr)
            self.saved[label] = (owner, attr, fn)
            setattr(owner, attr, self._wrap(label, fn))
        return self

    def _wrap(self, label, fn):
        rf = self.torch.profiler.record_function

        def wrapped(*a, **k):
            with rf(label):
                return fn(*a, **k)
        return wrapped

    def __exit__(self, *exc):
        for owner, attr, fn in self.saved.values():
            setattr(owner, attr, fn)
        return False


def phase_recurrent(torch, np, K):
    """Phases 23-25: zamba2-7b (staged and fused) and rwkv6-1.6b one-shot
    at full width and depth with exact launch counts, a trace of each
    with the device time of its recurrent scans, convolution, shared
    attention block and products, then both smoke configs card vs CPU.
    Returns ({arch: one-shot numbers}, {arch: trace})."""
    from repro_torch.models import mamba2, rwkv6
    from repro_torch.models.blocks import AttnBlock
    oneshot, traces = {}, {}
    zamba, oneshot["zamba2-7b"] = phase_oneshot(torch, np, K, "zamba2-7b",
                                                23)
    traces["zamba2-7b"] = phase_trace(
        torch, np, zamba, phase="  phase 23", spans={
            "mamba2 SSD scan": (mamba2, "_ssd_chunked"),
            "mamba2 causal conv": (mamba2, "_causal_conv"),
            # its torch ops; its own kernels are bound through ctypes, so
            # the trace reports them by name (scoring, attention kernels)
            "shared attention block (torch ops)": (AttnBlock, "apply")})
    del zamba
    torch.cuda.empty_cache()
    rwkv, oneshot["rwkv6-1.6b"] = phase_oneshot(
        torch, np, K, "rwkv6-1.6b", 24, routes=ROUTES[:1])
    traces["rwkv6-1.6b"] = phase_trace(
        torch, np, rwkv, phase="  phase 24", spans={
            "rwkv6 wkv scan": (rwkv6, "_time_mix_chunked"),
            "rwkv6 time mix": (rwkv6, "time_mix"),
            "rwkv6 channel mix": (rwkv6, "channel_mix")})
    del rwkv
    torch.cuda.empty_cache()
    log("== phase 25: recurrent smoke models, card (kernels) vs CPU (plain "
        "versions), prompt 160")
    small_card_vs_cpu(torch, np, ("zamba2-7b",), ROUTES, seed=25)
    small_card_vs_cpu(torch, np, ("rwkv6-1.6b",), ROUTES[:1], seed=25)
    return oneshot, traces


def phase_modality(torch, np, K):
    """Phases 26-28: whisper-small (12 decoder and 12 encoder layers over
    1500 frames) and internvl2-1b (256 patches + 7936 tokens) one-shot at
    full width and depth, staged and fused (g = 16), with exact launch
    counts (whisper: its 12 decoder layers' self-attention x 95; internvl2:
    24 x 95), TTFT (whisper's encoder and cross-KV build included), decode
    rate and peak memory, and a trace of each fused route with the device
    time of the encoder, the cross-KV build and the cross-attention
    (whisper) or the projector (internvl2; also timed by CUDA events
    outside the profiler); then both smoke configs card vs CPU.  Returns
    ({arch: one-shot numbers}, {arch: trace})."""
    from repro_torch.models.blocks import DecCrossBlock
    from repro_torch.models.model import Model
    oneshot, traces = {}, {}
    whisper, oneshot["whisper-small"] = phase_oneshot(
        torch, np, K, "whisper-small", 26)
    frames = prompt_batch(np, whisper.cfg, PROMPT, seed=26)["frames"]
    traces["whisper-small"] = phase_trace(
        torch, np, whisper, phase="  phase 26", spans={
            "encoder": (Model, "encode"),
            "cross-KV build": (Model, "_build_cross"),
            "cross-attention": (DecCrossBlock, "_cross")},
        frontend=lambda cache: whisper._build_cross(
            cache, whisper.encode(frames)))
    del whisper
    torch.cuda.empty_cache()
    internvl, oneshot["internvl2-1b"] = phase_oneshot(
        torch, np, K, "internvl2-1b", 27)
    patches = prompt_batch(np, internvl.cfg, PROMPT, seed=27)["patches"]
    traces["internvl2-1b"] = phase_trace(
        torch, np, internvl, phase="  phase 27",
        spans={"projector": (Model, "project")}, patches=patches)
    # the projector's device time outside any profiler session too: late
    # in a run the profiler may attribute none of its kernels to its range
    pt = torch.as_tensor(patches, dtype=internvl.cfg.compute_dtype,
                         device=internvl.device)
    proj = time_ms(torch, lambda: internvl.project(pt), None)
    log(f"  projector of {pt.shape[1]} patches, patches on the card: "
        f"{fmt(proj)}")
    traces["internvl2-1b"]["projector_ms"] = proj["device"]
    del internvl
    torch.cuda.empty_cache()
    log("== phase 28: modality smoke models, card (kernels) vs CPU (plain "
        "versions), 160 positions")
    small_card_vs_cpu(torch, np, ("whisper-small", "internvl2-1b"), ROUTES,
                      seed=28)
    return oneshot, traces


TRAIN_BATCH, TRAIN_SEQ = 8, 256    # phase 29: the launcher's defaults
TRAIN_ARGS = ["--arch", "granite-3-2b", "--steps", "3", "--batch",
              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
TRAIN_FAMILIES = ("granite-3-2b", "gemma3-27b", "olmoe-1b-7b",
                  "deepseek-v3-671b", "zamba2-7b", "rwkv6-1.6b",
                  "whisper-small", "internvl2-1b")


def phase_train_full(torch, np, card):
    """Phase 29: granite-3-2b trained at its published width (40 layers, d
    2048, GQA 32 / 8, d_ff 8192, vocab 49155; bf16, remat on) through
    ``launch/train.py`` for 3 steps of batch 8 x 256 tokens.  Checks: every
    step's loss and gradient norm finite, every weight matrix changed
    against the seed-0 draw; reports the step time (first step off the
    clock), tokens/s, peak memory and the model-FLOP share, and a later
    step's split into loss + backward and AdamW.  Then a save ->
    ``restore_state`` round trip of a smoke-width state on the card."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import REF_SEED, lm_batches
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import loop
    from repro_torch.training import optimizer as opt
    log("== phase 29: granite-3-2b training at full width, "
        + " ".join(TRAIN_ARGS))
    run = launch_train.main(TRAIN_ARGS)
    if not all(math.isfinite(x) for x in run.losses + run.grad_norms):
        raise AssertionError(f"phase 29: loss {run.losses} grad norm "
                             f"{run.grad_norms}")
    model = run.state.model
    fresh = build_model(model.cfg, model.device, seed=0)
    same = [n for (n, p), q in zip(model.named_parameters(),
                                   fresh.parameters())
            if p.ndim >= 2 and torch.equal(p.detach(), q)]
    n_mat = sum(p.ndim >= 2 for p in model.parameters())
    if same:
        raise AssertionError(f"phase 29: unchanged weights {same[:5]}")
    del fresh
    # where a step's time goes: two more steps, each split by device
    # synchronisations into loss + backward and AdamW (the second kept)
    params, ranks = list(model.parameters()), ckpt.leaf_ranks(model)
    gen = lm_batches(REF_SEED + 1, model.cfg.vocab, TRAIN_BATCH, TRAIN_SEQ)
    ostate = run.state.opt
    for _ in range(2):
        batch = next(gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grads = loop.value_and_grad(model, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ostate, _ = opt.apply_updates(params, grads, ostate,
                                      opt.OptimizerConfig(), ranks)
        torch.cuda.synchronize()
        split = {"loss_backward_ms": (t1 - t0) * 1e3,
                 "adamw_ms": (time.perf_counter() - t1) * 1e3}
        del grads
    step, share = run.mean_step_s(), run.flop_share()
    out = {"params": run.n_params, "tokens_per_step": run.tokens_per_step,
           "step_ms": [x * 1e3 for x in run.step_s],
           "step_ms_mean": step * 1e3,
           "tokens_per_s": run.tokens_per_step / step,
           "peak_gib": run.peak_gib, "model_flop_share": share,
           "loss": run.losses, "grad_norm": run.grad_norms, **split,
           "card": card}
    log(f"  {n_mat} weight matrices, every one changed; losses "
        f"{run.losses}, grad norms {run.grad_norms}")
    log(f"  step {step * 1e3:.1f} ms (steps 2-3; first "
        f"{run.step_s[0] * 1e3:.1f} ms), {out['tokens_per_s']:.0f} tok/s, "
        f"peak {run.peak_gib:.2f} GiB, model-FLOP share {share:.4f} "
        f"[{card}]")
    log(f"  a later step split: loss + backward "
        f"{split['loss_backward_ms']:.1f} ms, AdamW {split['adamw_ms']:.1f} "
        f"ms")
    del model, run, ostate
    torch.cuda.empty_cache()
    cfg = get_config("granite-3-2b").smoke()
    small = build_model(cfg, seed=29)
    state = loop.init_state(small, None)
    batch = {"tokens": np.random.default_rng(29).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32)}
    state, _ = loop.make_train_step(small, opt.OptimizerConfig(
        lr=1e-3, warmup_steps=1, total_steps=10))(state, batch)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        ckpt.save(path, state, {"step": 1})
        back, ostate = ckpt.restore_state(path, cfg)
        meta = ckpt.load_meta(path)
    pairs = list(zip(small.parameters(), back.parameters())) + list(
        zip(state.opt.mu + state.opt.nu, ostate.mu + ostate.nu))
    if meta != {"step": 1} or int(ostate.step) != 1 or not all(
            torch.equal(a.detach(), b) for a, b in pairs):
        raise AssertionError("phase 29: save -> restore_state round trip")
    log(f"  smoke state saved and restored on the card: {len(pairs)} "
        f"tensors equal, step 1")
    return out


def phase_train_families(torch, np):
    """Phase 30: one fp32 training step of every family's smoke config
    (96 tokens), card against CPU from the same weights, remat off and on:
    the loss within 1e-5 relative, the gradient norm within 1e-5
    relative, every gradient leaf within 1e-4 of its largest magnitude
    (rwkv6 5e-3 for the norm and the leaves: its wkv recurrence's fp32
    conditioning, measured in ``tests/test_torch_train_families.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import loop
    from repro_torch.training import optimizer as opt
    log("== phase 30: every family's smoke training step, card vs CPU, "
        "remat off and on")
    ocfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for arch in TRAIN_FAMILIES:
        for remat in (False, True):
            cfg = dataclasses.replace(get_config(arch).smoke(), remat=remat)
            cpu = build_model(cfg, device="cpu", seed=30)
            gpu = ckpt.from_flat(ckpt.to_flat(cpu), cfg)
            batch = prompt_batch(np, cfg, 96 + cfg.prefix_positions, b=2,
                                 seed=30)
            res = []
            for model in (cpu, gpu):
                state = loop.init_state(model, None)
                _, grads = loop.value_and_grad(model, batch)
                index = {p: i for i, p in enumerate(model.parameters())}
                flat = ckpt.to_flat(model, lambda p: grads[index[p]])
                _, m = loop.make_train_step(model, ocfg)(state, batch)
                res.append((float(m["loss"]), float(m["grad_norm"]), flat))
            (lc, nc, gc), (lg, ng, gg) = res
            rwkv = arch == "rwkv6-1.6b"
            tol = 5e-3 if rwkv else 1e-4
            e_grad = max(float(np.abs(gg[k] - w).max()
                               / max(np.abs(w).max(), 1e-30))
                         for k, w in gc.items())
            label = f"{arch} remat={remat}"
            check(f"{label} loss", abs(lg - lc) / abs(lc), 1e-5, "relative")
            check(f"{label} grad norm", abs(ng - nc) / nc,
                  5e-3 if rwkv else 1e-5, "relative")
            check(f"{label} gradients", e_grad, tol,
                  "of each leaf's largest magnitude")
            out[label] = {"loss": lg, "loss_cpu": lc, "grad_err": e_grad}
    return out


def phase_train_retrieval(torch, np, K):
    """Phase 31: the retrieval model of the reference's
    ``tests/test_system.py`` trained on the card (granite smoke, 2 layers,
    d 128, fp32; 250 steps on the needle task), then read back through
    chunked prefill: dense accuracy at 97 tokens >= 0.7, and at 161 tokens
    QUOKA >= dense - 0.25, every chunk of every layer through the scoring
    and flash kernels (launch counts = counted chunk calls x layers)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import (REF_SEED, needle_accuracy,
                                            needle_batch, needle_batches)
    from repro_torch.models.model import build_model
    from repro_torch.training import loop
    from repro_torch.training import optimizer as opt
    log("== phase 31: retrieval model trained on the card, read back "
        "through QUOKA's kernels")
    cfg = get_config("granite-3-2b").smoke(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=256)
    cfg = dataclasses.replace(
        cfg, quoka=dataclasses.replace(cfg.quoka, chunk_size=32, budget=48,
                                       n_queries=8, keep_first=4))
    model = build_model(cfg, seed=0)
    t0 = time.perf_counter()
    _, hist = loop.train(
        model, needle_batches(REF_SEED, cfg.vocab, 16, 97, n_keys=16),
        steps=250, log_every=50, state=loop.init_state(model, None),
        ocfg=opt.OptimizerConfig(lr=3e-3, warmup_steps=20, total_steps=250))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    chunk_calls = [0]
    apply_stacks = model._apply_stacks

    def counted(*a, **kw):
        chunk_calls[0] += 1
        return apply_stacks(*a, **kw)

    model._apply_stacks = counted
    acc = {}
    runs = (("full", 97, 7), ("full", 161, 11), ("quoka", 161, 11))
    for method, t, seed in runs:
        batch = needle_batch(np.random.default_rng(seed), cfg.vocab, 16, t,
                             n_keys=16)
        chunk_calls[0] = 0
        reset_counts(K)
        acc[f"{method} T={t}"] = needle_accuracy(model, batch, method)
        counts = read_counts(K)
        n = chunk_calls[0] * cfg.n_layers if method == "quoka" else 0
        want = {"quoka_score": n, "flash_attention": n,
                "selected_attention": 0, "selected_attention_paged": 0}
        if counts != want or chunk_calls[0] != (t - 1) // 32:
            raise AssertionError(f"phase 31 {method} T={t}: launches "
                                 f"{counts} != {want} over {chunk_calls[0]} "
                                 f"chunk calls")
        log(f"  {method:6s} T={t}: accuracy {acc[f'{method} T={t}']:.3f}, "
            f"{chunk_calls[0]} chunk calls, launches {counts}")
    log(f"  trained 250 steps in {train_s:.1f} s, losses {hist}")
    if acc["full T=97"] < 0.7 or \
            acc["quoka T=161"] < acc["full T=161"] - 0.25:
        raise AssertionError(f"phase 31: accuracies {acc}")
    return {"train_s": train_s, "losses": hist, "accuracy": acc}


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
    """(least time in ms, "bytes" or "operations") at the H100 SXM's
    data-sheet peaks (``analysis/roofline.py``: 3.35 TB/s, 989 TFLOP/s)."""
    from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS
    tb = nbytes / HBM_BW * 1e3
    tf = flops / PEAK_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


ATTN_KERNELS = ("attn_mma_kernel", "attn_merge_kernel")
SCORE_KERNELS = ("score_kernel",)


def traced_kernels(torch, call, names, reps):
    """({kernel: (launches, device us, {grids})} of the kernels ``names``,
    the number of kernel events of any name) in a ``torch.profiler`` trace
    of ``reps`` eager calls, after ``reps`` untraced ones, in one profiler
    session with no schedule (at phase 19 of a whole run a scheduled
    session recorded no kernel event in 3 of 3 traces, plain ones in 0 of
    3)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    seen = {}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    for e in kernels:
        name = next((k for k in names if k in e.get("name", "")), None)
        if name is None:
            continue
        grid = tuple(e["args"]["grid"])
        n, us, grids = seen.get(name, (0, 0.0, set()))
        seen[name] = (n + 1, us + float(e["dur"]), grids | {grid})
    return seen, len(kernels)


def launched(torch, call, names=ATTN_KERNELS, reps=10):
    """The kernels ``names`` that one ``call`` launches, as a
    ``torch.profiler`` trace of ``reps`` eager calls records them:
    ``(n_split, blocks, {kernel: (grid, device ms per launch, launches
    recorded)}, traces)`` with blocks summed over the kernels' grids, for
    the bf16 attention kernels n_split the first grid dimension of
    ``attn_mma_kernel`` (else None), and ``traces`` the number of traces
    taken (the kernels line reports it per row).  Fails unless each
    kernel recorded ran with one grid and at most once per call, and the
    attention merge ran exactly when the walk was split.  When ten
    traces record no ``names[0]`` (the profiler drops kernel records in
    some sessions, more often late in a run: PERF.md section 7), returns
    ``(None, None, {}, 10)``; the caller's ``LaunchCheck`` is then what
    shows the kernel ran."""
    for traces in range(1, 11):
        seen, n_kernels = traced_kernels(torch, call, names, reps)
        if names[0] in seen:
            break
        # the profiler drops kernel records in some sessions (8 or 9 of
        # 10 recorded; late in a run often none, session after session,
        # which Kineto's log counts as out of range): trace again
        log(f"    (profiler recorded no {names[0]} among {n_kernels} kernel "
            f"events; tracing again)")
    else:
        return None, None, {}, traces
    out = {}
    for name, (n, us, grids) in seen.items():
        if n > reps or len(grids) != 1:
            raise AssertionError(f"{name}: {n} launches in {reps} calls, "
                                 f"grids {grids}")
        out[name] = (grids.pop(), us / n / 1e3, n)
    blocks = sum(math.prod(g) for g, _, _ in out.values())
    if names != ATTN_KERNELS:
        return None, blocks, out, traces
    grid = out["attn_mma_kernel"][0]
    if (grid[0] > 1) != ("attn_merge_kernel" in out):
        raise AssertionError(f"S={grid[0]} but kernels {sorted(out)}")
    return grid[0], blocks, out, traces


def fmt_launched(n_split, blocks, kernels, traces) -> str:
    if not kernels:
        return f"not recorded by the profiler in {traces} traces"
    parts = [f"{k} grid {g} {ms:.4f} ms ({n} recorded)"
             for k, (g, ms, n) in kernels.items()]
    split = "" if n_split is None else f"S={n_split}, "
    return (f"{split}{blocks} blocks ({'; '.join(parts)}; "
            f"{traces} trace{'s' if traces > 1 else ''})")


class LaunchCheck:
    """``call`` that counts its calls, and ``check`` that holds the kernel
    wrapper's launch counter ``count()`` to one launch per call since the
    check was made: the proof, independent of the profiler, that the
    timed calls ran the hand-written kernel (a graph capture counts as a
    call; its replays call nothing)."""

    def __init__(self, call, count):
        self.call, self.count = call, count
        self.calls, self.n0 = 0, count()

    def __call__(self):
        self.calls += 1
        return self.call()

    def check(self, label) -> str:
        n = self.count() - self.n0
        if n != self.calls:
            raise AssertionError(f"{label}: {n} kernel launches in "
                                 f"{self.calls} calls")
        return f"{n} kernel launches in {self.calls} calls"


def time_row(torch, flush, label, call, plain, b_ms, b_by, count,
             lib_ms=None, warm_main=True, names=ATTN_KERNELS, b2b=None,
             traced=None):
    """One kernel row of phase 6: device time with L2 warm, with L2
    flushed and back to back (``b2b``: 20 calls captured in one graph, by
    default ``call`` 20 times), the plain version, a library call's time
    where one exists, the bound, and the kernels a call of ``traced``
    (default ``call``) launched (grids, blocks, device times), read from
    a profiler trace.  ``count()`` (the kernel wrapper's launch counter)
    must rise by one for each ``call`` the warm and flushed timings make,
    else the row fails.  "ms" is the time with L2 as the main path leaves
    it: warm when ``warm_main``, else flushed."""
    timed = LaunchCheck(call, count)
    warm = time_ms(torch, timed, None)
    cold = time_ms(torch, timed, flush)
    counted = timed.check(label)
    # 20 calls back to back in one graph: the per-call device time
    # without the fixed cost of launching a graph for a single call
    b2b_ms = time_ms(torch, b2b or (lambda: [call() for _ in range(20)]),
                     None, iters=5)["device"] / 20
    p_ms = time_ms(torch, plain, None if warm_main else flush)
    main = warm if warm_main else cold
    n_split, blocks, kernels, traces = launched(torch, traced or call,
                                                names)
    lib = f"  sdpa {fmt(lib_ms)}" if lib_ms else ""
    seen = f"{counted}; {fmt_launched(n_split, blocks, kernels, traces)}"
    log(f"  {label}: {fmt(main)}  L2-warm {warm['device']:.4f}  "
        f"L2-flushed {cold['device']:.4f}  back-to-back {b2b_ms:.4f}  "
        f"plain {fmt(p_ms)}{lib}  bound {b_ms:.4f} ({b_by})  "
        f"{seen}")
    r = dict(ms=main["device"], warm_ms=warm["device"],
             cold_ms=cold["device"], b2b_ms=b2b_ms, plain_ms=p_ms["device"],
             bound_ms=b_ms, bound_by=b_by,
             library_ms=lib_ms["device"] if lib_ms else None,
             blocks=blocks, traces=traces,
             kernel_ms={k: ms for k, (_, ms, _) in kernels.items()})
    if n_split is not None:
        r["n_split"] = n_split
    return r


def attention_times(torch, np, dev, K, flush):
    """Flash and linear selected attention at the main path's prefill
    (tq = 128) and decode (tq = 1) shapes, qwen3-4b's (h 32 / 8, d 128),
    stablelm-3b's (MHA 32 / 32, d 80) and gemma3-27b's global layers' (h
    32 / 16, a budget of 2048) and zamba2-7b's shared block's (MHA 32 /
    32, d 112), whisper-small's decoder self-attention (MHA 12 / 12, d 64,
    a budget of 512) and internvl2-1b's (GQA 14 / 2, d 64): device time
    with L2 warm, with
    L2 flushed and back to back, the plain version, SDPA for flash, the
    bound, and the kernels one call launched (their grids, so the split
    count and the blocks, and their device times), read from a profiler
    trace.  Returns {kernel: row}: qwen3-4b's prefill numbers at the top
    level, its decode ones under "decode", stablelm-3b's under "d80" and
    "d80_decode", gemma3-27b's under "gemma3" and "gemma3_decode",
    zamba2-7b's under "d112" and "d112_decode", whisper-small's and
    internvl2-1b's under "whisper", "whisper_decode", "internvl2" and
    "internvl2_decode"; "ms" is
    the time with L2 as the main path leaves it
    (flash: warm, the tensors just written; selected: flushed, a cache the
    other layers have evicted)."""
    import torch.nn.functional as F
    fa, sa, ref = K["flash"], K["selected"], K["ref"]
    out = {"flash_attention": {}, "selected_attention": {}}

    count = {"flash_attention": lambda: fa.LAUNCHES,
             "selected_attention": lambda: sa.LAUNCHES}

    def row(name, key, label, call, plain, b_ms, b_by, lib_ms=None,
            warm_main=True):
        r = time_row(torch, flush, f"{name} {label}", call, plain, b_ms,
                     b_by, count[name], lib_ms, warm_main)
        if key is None:
            out[name].update(r)
        else:
            out[name][key] = r

    for tag, (h, n_kv, d), budget in (
            ("", (32, 8, 128), 1024),
            ("d80", ARCH_SHAPES["stablelm-3b"], 1024),
            ("gemma3", ARCH_SHAPES["gemma3-27b"], GEMMA_BUDGET),
            ("d112", ARCH_SHAPES["zamba2-7b"], 1024),
            ("whisper", ARCH_SHAPES["whisper-small"], WHISPER_BUDGET),
            ("internvl2", ARCH_SHAPES["internvl2-1b"], 1024)):
        group = h // n_kv
        for tq in (128, 1):
            key = ((tag + "_decode") if tag else "decode") if tq == 1 \
                else (tag or None)
            # an empty KV head is half the work at n_kv 2 (internvl2), far
            # from the main path's: time such a geometry with none
            q, k, v, valid, B = flash_inputs(torch, dev, tq, h, n_kv, d,
                                             B=budget, empty=n_kv >= 8)
            tk = k.shape[2]
            i = torch.arange(tq, device=dev)[:, None]
            j = torch.arange(tk, device=dev)[None, :]
            mask = ((j < B) | (j - B <= i))[None, None] & \
                valid.repeat_interleave(group, dim=1)[:, :, None, :]
            pairs = int(mask.sum())
            o = torch.empty_like(q)
            # K/V rows masked by k_valid are never needed
            kv_bytes = 2 * int(valid.sum()) * d * k.element_size()
            b_ms, b_by = bound(nbytes(q, valid, o) + kv_bytes,
                               4 * d * pairs)
            kr = k.repeat_interleave(group, dim=1)
            vr = v.repeat_interleave(group, dim=1)
            l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, kr, vr, attn_mask=mask), None)
            row("flash_attention", key,
                f"{'prefill' if tq > 1 else 'decode'} tq={tq} tk={tk} "
                f"h={h}/{n_kv} d={d}",
                lambda: fa.flash_attention_bhtd(q, k, v, valid, causal=True,
                                                boundary=B),
                lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                                boundary=B, k_valid=valid),
                b_ms, b_by, l_ms)
        for g, t, start in ((16, 128, 4096), (16, 1, 8197)):
            key = ((tag + "_decode") if tag else "decode") if t == 1 \
                else (tag or None)
            q, k, v, key_pos, idx, st = selected_inputs(
                torch, np, dev, g, t, start, B=budget, h=h, n_kv=n_kv, d=d)
            # keys this data needs: valid selected slots and the chunk rows
            blocks = idx[idx >= 0]
            rows_sel = (blocks[:, None] * g
                        + torch.arange(g, device=dev)).reshape(-1)
            pos_sel = key_pos[0, rows_sel]
            n_sel = int(((pos_sel >= 0) & (pos_sel < st)).sum())
            n_chunk_pairs = t * (t + 1) // 2
            pairs = h * (n_sel * t + n_chunk_pairs)
            o = torch.empty_like(q)
            kv_rows = n_kv * (n_sel + t) * d * 2 * 2
            b_ms, b_by = bound(nbytes(q, o, idx) + kv_rows
                               + 4 * (len(rows_sel) + t), 4 * d * pairs)
            # the start as a device tensor: a graph cannot capture the
            # host-to-device copy that a Python int costs the plain version
            st_dev = torch.full((1,), st, dtype=torch.int32, device=dev)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), \
                v.transpose(1, 2)
            row("selected_attention", key,
                f"{'prefill' if t > 1 else 'decode'} g={g} t={t} "
                f"h={h}/{n_kv} d={d}",
                lambda: sa.selected_attention_bhtd(q, k, v, key_pos, idx,
                                                   st_dev, granularity=g),
                lambda: ref.selected_ref(qt, kt, vt, key_pos, idx, st_dev,
                                         g),
                b_ms, b_by, warm_main=False)
    return out


def sdpa_backend(torch, call) -> str:
    """The backend one ``scaled_dot_product_attention`` call took, read off
    the names of the kernels a profiler trace of it records: flash,
    efficient (cutlass fmha), cudnn, else math (the plain products), or
    "not recorded" when the trace holds no kernel at all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    # CPU and CUDA, as ``traced_kernels``: late in a run a CUDA-only
    # session mostly records no kernel
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA).lower()
    if not names:
        return "not recorded"
    for tag, backend in (("flash", "flash"), ("fmha", "efficient"),
                         ("efficient", "efficient"), ("cudnn", "cudnn")):
        if tag in names:
            return backend
    return "math"


def mla_times(torch, dev, K, flush):
    """Phase 6, flash at deepseek-v3's shapes (b 1, 128 heads over one
    latent KV head, d 576, V the 512-wide latent): prefill (tq 128, tk 1152)
    and decode (tq 1, tk 1025), as ``attention_times`` times qwen3-4b's
    rows, beside SDPA on the same inputs, the same mask and scale, in two
    forms that copy no K or V: K and V expanded to 128 heads (stride-0
    views), and the 128 heads folded into the query rows of the one KV
    head (q's storage is (b, tq, h, d), so the fold is a view).  The
    faster is the row's library time; each form's time and the backend it
    took are kept.  Returns {"d576": prefill row, "d576_decode": decode
    row}."""
    rows = {}
    for tq in (128, 1):
        q, k, v, valid, B = mla_flash_inputs(torch, dev, tq, torch.bfloat16)
        rows["d576" if tq > 1 else "d576_decode"] = mla_flash_row(
            torch, K, flush, q, k, v, valid, B,
            "prefill" if tq > 1 else "decode")
    return rows


def mla_flash_row(torch, K, flush, q, k, v, valid, B, what):
    """One flash row at MLA's width (q (b, h, tq, 576) with (b, tq, h, d)
    storage, one KV head, V the latent's first 512 columns, validity
    (b, tk) or (b, 1, tk), a budget of B keys): its bound, SDPA in both
    forms of ``mla_sdpa_forms`` (each checked against the plain version,
    the faster the row's library time) and ``time_row``."""
    fa, ref = K["flash"], K["ref"]
    dev = q.device
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    valid = valid.reshape(b, tk)
    i = torch.arange(tq, device=dev)[:, None]
    j = torch.arange(tk, device=dev)[None, :]
    mask = ((j < B) | (j - B <= i))[None, None] & valid[:, None, None]
    pairs = h * int(mask.sum())
    o = torch.empty((b, h, tq, v.shape[-1]), dtype=q.dtype, device=dev)
    # K and V rows masked by k_valid are never needed; MLA's V is K's
    # first 512 columns (a view), so those bytes are read once
    n_valid = int(valid.sum())
    aliased = v.data_ptr() == k.data_ptr() and v.stride() == k.stride()
    kv_cols = MLA_D if aliased else MLA_D + MLA_DV
    b_ms, b_by = bound(nbytes(q, valid, o)
                       + n_valid * kv_cols * q.element_size(),
                       2 * (MLA_D + MLA_DV) * pairs)
    want = ref.flash_attention_ref(q, k, v, causal=True, boundary=B,
                                   k_valid=valid, scale=MLA_SCALE)
    sdpa = {}
    for form, call in mla_sdpa_forms(torch, q, k, v, mask).items():
        # a wrong view or mask is off by O(1); bf16 rounding is not
        rel = max_err(call(), want) / float(want.abs().max())
        check(f"SDPA {form} d=576 tq={tq} vs plain (relative)", rel,
              2e-2, "the same function: bf16 SDPA against fp32 sums")
        sdpa[form] = (time_ms(torch, call, None),
                      sdpa_backend(torch, call))
        log(f"    sdpa {form}: {fmt(sdpa[form][0])}, backend "
            f"{sdpa[form][1]}")
    best = min(sdpa, key=lambda f: sdpa[f][0]["device"])
    label = f"{what} tq={tq} tk={tk} h={h}/1 d={MLA_D} dv={MLA_DV}"
    r = time_row(
        torch, flush, f"flash_attention {label}",
        lambda: fa.flash_attention_bhtd(q, k, v, valid, causal=True,
                                        boundary=B, scale=MLA_SCALE),
        lambda: ref.flash_attention_ref(q, k, v, causal=True, boundary=B,
                                        k_valid=valid, scale=MLA_SCALE),
        b_ms, b_by, lambda: fa.LAUNCHES, sdpa[best][0])
    r.update(sdpa_form=best, sdpa_backend=sdpa[best][1],
             sdpa_ms={f: t["device"] for f, (t, _) in sdpa.items()},
             sdpa_backends={f: be for f, (_, be) in sdpa.items()})
    return r


def mla_sdpa_forms(torch, q, k, v, mask):
    """SDPA calls for flash at MLA's shapes (q (1, h, tq, d) with (b, tq,
    h, d) storage, one KV head k (1, 1, tk, d), v (1, 1, tk, dv), a bool
    mask (1, 1, tq, tk)) that copy no K or V: "expand", K and V expanded
    to h heads (stride-0 views); "folded", the h heads folded into the
    query rows of the one KV head (row i * h + head is query i of head).
    Each returns (1, h, tq, dv)."""
    import torch.nn.functional as F
    b, h, tq, d = q.shape
    ke, ve = k.expand(-1, h, -1, -1), v.expand(-1, h, -1, -1)
    qf = q.transpose(1, 2).reshape(b, 1, tq * h, d)
    mf = mask.repeat_interleave(h, dim=2)
    return {
        "expand": lambda: F.scaled_dot_product_attention(
            q, ke, ve, attn_mask=mask, scale=MLA_SCALE),
        "folded": lambda: F.scaled_dot_product_attention(
            qf, k, v, attn_mask=mf, scale=MLA_SCALE).reshape(
                b, tq, h, v.shape[-1]).transpose(1, 2)}


def phase_timing(torch, np, dev, K, paged):
    """Phase 6: each kernel at its main-path prefill and decode shapes
    against its bound, its plain version and, for flash, SDPA with the same
    mask.  ``paged`` = (q (b, t, h, d), k_pool, v_pool,
    pos_pool, table, plan ids, starts) from phase 9's serve pool."""
    qs, sa, ref = K["score"], K["selected"], K["ref"]
    junk = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        junk.fill_(1)

    log("== phase 6: kernel times (ms; device = graph replay)")
    rows = {"quoka_score": {}}
    # scoring and selected attention read the layer's KV cache, which the
    # other layers' weights have pushed out of L2 since its last use: flush.
    # Score: a mid-prefill chunk (half the cap is prior context), the last
    # chunk and the first decode step (all of the prompt is).  Back to
    # back and in the trace, each call reads its own copy of the cache (20
    # copies, 336 MB, far past the 50 MB L2), so those times are cold too.
    # The last row is low-rank scoring (score_proj_dim = 32): the kernel at
    # d = 32 on the projected cache, mid-prefill.
    # The d576 row is deepseek-v3's latent (one KV head, d = 576) at its
    # last prefill chunk; the d120 row h2o-danube-3-4b's wrapped ring (n_kv
    # 8, d 120, T 4096) at a mid-prefill chunk; the d112 rows zamba2-7b's
    # shared block (n_kv 32, d 112) mid-prefill and at decode; the whisper
    # rows whisper-small's decoder (n_kv 12, d 64), the internvl2 rows
    # internvl2-1b's LM (n_kv 2, d 64), mid-prefill and at decode.
    for key, n_q, start, rank, n_kv, d in (
            ("prefill", 16, 4096, 0, 8, 128),
            ("last_chunk", 16, PROMPT, 0, 8, 128),
            ("decode", 1, PROMPT, 0, 8, 128),
            ("proj32", 16, 4096, 32, 8, 128),
            ("d576", 16, PROMPT, 0, 1, MLA_D),
            ("d120_ring", 16, RING_START, 0, 8, RING_D),
            ("d112", 16, 4096, 0, 32, 112),
            ("d112_decode", 1, PROMPT, 0, 32, 112),
            ("whisper", 16, 4096, 0, 12, 64),
            ("whisper_decode", 1, PROMPT, 0, 12, 64),
            ("internvl2", 16, 4096, 0, 2, 64),
            ("internvl2_decode", 1, PROMPT, 0, 2, 64)):
        if rank:
            qb, kt, valid = projected_score_inputs(torch, dev, n_q, rank,
                                                   start)
        elif key == "d120_ring":
            qb, kt, valid = ring_score_inputs(torch, dev, n_q,
                                              torch.bfloat16)
        else:
            qb, kt, valid = score_inputs(torch, dev, n_q, start, n_kv=n_kv,
                                         d=d)
        d = kt.shape[-1]
        copies = [kt.transpose(1, 2).clone().transpose(1, 2)
                  for _ in range(20)]
        out = torch.empty((1, n_kv, kt.shape[2]), device=dev)
        # an invalid slot scores NEG_INF unread: only valid key rows count
        n_valid = int(valid.sum())
        k_bytes = n_kv * n_valid * d * kt.element_size()
        b_ms, b_by = bound(nbytes(qb, valid, out) + k_bytes,
                           2 * n_kv * n_valid * d * (n_q + 1))
        turn = iter(range(10 ** 9))

        def rotating():
            return qs.quoka_score_bhtd(qb, copies[next(turn) % 20], valid)
        r = time_row(
            torch, flush, f"quoka_score n_q={n_q} n_kv={n_kv} d={d} valid "
            f"{n_valid}/{kt.shape[2]}",
            lambda: qs.quoka_score_bhtd(qb, kt, valid),
            lambda: ref.score_ref(qb, kt, valid), b_ms, b_by,
            lambda: qs.LAUNCHES, warm_main=False, names=SCORE_KERNELS,
            b2b=lambda: [qs.quoka_score_bhtd(qb, c, valid) for c in copies],
            traced=rotating)
        if key == "prefill":
            rows["quoka_score"].update(r)
        else:
            rows["quoka_score"][key] = r
        del copies
    rows.update(attention_times(torch, np, dev, K, flush))
    rows["flash_attention"].update(mla_times(torch, dev, K, flush))
    # the paged kernel on the serve pool, one request row (the shape of
    # the linear kernel's row above) and the whole 4-row step; the pool is
    # cold in L2 as each layer finds it
    q4, kp, vp, pos, tab4, idx4, st4 = paged
    g, t = 16, q4.shape[1]
    bs, n_kv, d = kp.shape[1:]
    h = q4.shape[2]
    for b in (1, 4):
        q, tab, idx, st = q4[:b], tab4[:b], idx4[:b], st4[:b]
        _, _, kpos = ref.linearize_pool(kp, vp, pos, tab)
        n_sel = 0
        for bi in range(b):
            blocks = idx[bi][idx[bi] >= 0]
            rows_sel = (blocks[:, None] * g
                        + torch.arange(g, device=dev)).reshape(-1)
            pos_sel = kpos[bi, rows_sel]
            n_sel += int(((pos_sel >= 0) & (pos_sel < st[bi])).sum())
        # chunk rows this data needs: the mapped, written ones; chunk key
        # j is attended by the t - j query rows at or after it
        j = torch.arange(t, device=dev)
        c_ok = torch.gather(kpos, 1, st[:, None].long() + j) >= 0
        n_chunk = int(c_ok.sum())
        pairs = h * (n_sel * t + int((c_ok * (t - j)).sum()))
        out = torch.empty_like(q)
        kv_rows = n_kv * (n_sel + n_chunk) * d * 2 * kp.element_size()
        b_ms, b_by = bound(nbytes(q, out, idx, tab) + kv_rows
                           + 4 * (idx.numel() * g + b * t), 4 * d * pairs)
        qt = q.transpose(1, 2)

        call = LaunchCheck(lambda: sa.selected_attention_paged(
            qt, kp, vp, pos, idx, st, tab, granularity=g, block_size=bs),
            lambda: sa.PAGED_LAUNCHES)
        ms = time_ms(torch, call, flush)
        counted = call.check(f"selected_attention_paged rows={b}")
        p_ms = time_ms(torch, lambda: ref.selected_paged_ref(
            q, kp, vp, pos, idx, st, tab, g), flush)
        seen = launched(torch, call.call)
        log(f"  selected_attention_paged g={g} t={t} rows={b}: {fmt(ms)}  "
            f"plain {fmt(p_ms)}  bound {b_ms:.4f} ({b_by})  {counted}; "
            f"{fmt_launched(*seen)}")
        if b == 1:
            rows["selected_attention_paged"] = dict(
                ms=ms["device"], plain_ms=p_ms["device"], bound_ms=b_ms,
                bound_by=b_by, library_ms=None, traces=seen[3])
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
    t_start = time.perf_counter()

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
            "selected_attention": 0, "selected_attention_paged": 0}
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
            "selected_attention": per_run, "selected_attention_paged": 0}
    if c_fu != want:
        raise AssertionError(f"fused launches {c_fu} != {want}")
    state, kv0, tables, serve, serve_errs = phase_serve(torch, np, K, model)
    for name, err in serve_errs.items():
        errs[name] = max(errs[name], err)
    e_paged, n_paged, (q, pos, tab, idx, st, _) = \
        phase_paged(torch, np, K, state, kv0, tables)
    errs["selected_attention_paged"] = max(errs["selected_attention_paged"],
                                           e_paged)
    paged = (q, kv0.k, kv0.v, pos, tab, idx, st)
    del state
    torch.cuda.empty_cache()
    telemetry = phase_telemetry(torch, np, K, model, card)
    model.cfg = cfg
    trace = phase_trace(torch, np, model)
    del model
    torch.cuda.empty_cache()

    phase_small_agreement(torch, np)
    phase_small_serve(torch, np)
    timing = phase_timing(torch, np, dev, K, paged)
    # the comparison path after phases 1-10, which keep the parent's order
    methods = phase_methods(torch, np, K, build_model(dataclasses.replace(
        cfg, n_layers=METHOD_LAYERS), seed=0), card)
    torch.cuda.empty_cache()
    harness = phase_harness(torch, np, K, card, dev)
    phase_small_baselines(torch, np)
    # the slice's paths: llama3-2-3b one-shot, its serve over the host
    # tier (on the same model), stablelm-3b one-shot
    torch.cuda.empty_cache()
    llama, oneshot = phase_oneshot(torch, np, K, "llama3-2-3b", 14,
                                   layers=LLAMA_LAYERS)
    oneshot = {f"llama3-2-3b ({LLAMA_LAYERS} layers)": oneshot}
    tier = phase_host_tier(torch, np, K, llama)
    del llama
    torch.cuda.empty_cache()
    stablelm, oneshot[f"stablelm-3b ({STABLELM_LAYERS} layers)"] = \
        phase_oneshot(torch, np, K, "stablelm-3b", 15,
                      layers=STABLELM_LAYERS)
    del stablelm
    torch.cuda.empty_cache()
    # the MoE and MLA slice: olmoe-1b-7b, then deepseek-v3 cut to 4 layers
    oneshot["olmoe-1b-7b"], olmoe = phase_olmoe(torch, np, K)
    deepseek, ds_model = phase_deepseek(torch, np, K)
    oneshot["deepseek-v3 (4 layers)"] = {"staged": deepseek}
    # the sliding-window and latent-pool slice: deepseek-v3 served on
    # phase 18's model, h2o-danube-3-4b, the smoke window models, then
    # gemma3-27b cut to two periods
    ds_serve, ds_rows = phase_deepseek_serve(torch, np, K, ds_model)
    timing["flash_attention"].update(ds_rows)
    del ds_model
    torch.cuda.empty_cache()
    danube, oneshot["h2o-danube-3-4b"] = phase_oneshot(
        torch, np, K, "h2o-danube-3-4b", 20)
    window_traces = {"h2o-danube-3-4b": phase_trace(
        torch, np, danube, phase="  phase 20")}
    del danube
    torch.cuda.empty_cache()
    phase_window_small(torch, np)
    torch.cuda.empty_cache()
    log(f"  before phase 22: {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
        f"GiB allocated on the card")
    gemma, oneshot[f"gemma3-27b ({GEMMA_LAYERS} layers)"] = phase_oneshot(
        torch, np, K, "gemma3-27b", 22, layers=GEMMA_LAYERS)
    # prompt 4096: at 2048 the global layers' cap (2064) is within budget
    # 2048 + chunk, so they would take the dense bypass, off the main path
    window_traces["gemma3-27b"] = phase_trace(torch, np, gemma, prompt=4096,
                                              phase="  phase 22")
    del gemma
    torch.cuda.empty_cache()
    # the recurrent slice
    recurrent, recurrent_traces = phase_recurrent(torch, np, K)
    oneshot.update(recurrent)
    torch.cuda.empty_cache()
    # the modality slice
    modality, modality_traces = phase_modality(torch, np, K)
    oneshot.update(modality)
    torch.cuda.empty_cache()
    # the training slice
    training = {"granite-3-2b": phase_train_full(torch, np, card),
                "families": phase_train_families(torch, np),
                "retrieval": phase_train_retrieval(torch, np, K)}

    launches = {"quoka_score": c_st["quoka_score"],
                "flash_attention": c_st["flash_attention"],
                "selected_attention": c_fu["selected_attention"],
                "selected_attention_paged": n_paged}
    meta = {
        "quoka_score": ("src/repro_torch/kernels/csrc/quoka_score.cu",
                        "src/repro/kernels/quoka_score.py:45"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:93"),
        "selected_attention": (
            "src/repro_torch/kernels/csrc/selected_attention.cu",
            "src/repro/kernels/selected_attention.py:183"),
        "selected_attention_paged": (
            "src/repro_torch/kernels/csrc/selected_attention_paged.cu",
            "src/repro/kernels/selected_attention.py:304"),
    }
    # launches on each main path of the run, beside qwen3-4b's
    paths = {name: {"qwen3-4b staged": c_st[name],
                    "qwen3-4b fused": c_fu[name]} for name in meta}
    for arch, runs in oneshot.items():
        for route, r in runs.items():
            for name in meta:
                paths[name][f"{arch} {route}"] = r["launches"][name]
    for name in meta:
        paths[name]["deepseek-v3 (4 layers) serve"] = \
            ds_serve["launches"][name]
    kernels = []
    for name, (src, repl) in meta.items():
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=repl, launches=launches[name],
                            max_abs_err=errs[name], paths=paths[name],
                            **timing[name]))
    main_path = {
        "staged": dict(ttft_s=r_st.ttft_s, decode_tok_s=r_st.decode_tps,
                       peak_gib=peak_st),
        "fused": dict(ttft_s=r_fu.ttft_s, decode_tok_s=r_fu.decode_tps,
                      peak_gib=peak_fu)}
    log(json.dumps({"main_path": main_path, "trace": trace,
                    "serve": serve, "methods": methods,
                    "harness": harness, "oneshot": oneshot,
                    "host_tier": tier, "olmoe": olmoe,
                    "deepseek_serve": ds_serve,
                    "window_traces": window_traces,
                    "recurrent_traces": recurrent_traces,
                    "modality_traces": modality_traces,
                    "training": training, "telemetry": telemetry,
                    "elapsed_s": time.perf_counter() - t_start}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
