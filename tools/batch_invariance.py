"""Is the card's fp32 prefill batch-invariant?  One meshless QUOKA prefill
of a seeded two-row batch on the card, then of its first row alone, at
the published width cut in depth, budget 256: prints, for every scoring
call where the two runs differ, how far apart their keys and scores are,
how far each score is from the kernel's plain version, and how many plan
slots differ; then each run's first-step logits against the CPU's on the
same flat weights.  A mesh that splits rows over ``data`` runs each
rank's rows at batch 1, so where a near-tie in the top-k flips here, a
meshless and a mesh run can part ways while both are right.

    python3 tools/batch_invariance.py [ARCH] [LAYERS] [PROMPT]

(default internvl2-1b 4 768; needs a CUDA card.)
"""
import dataclasses as dc
import os
import sys

import numpy as np
import torch


def main(arch="internvl2-1b", layers=4, prompt=768):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [os.path.join(root, "src"), os.path.join(root, "tests")]
    import torch_tp_cases as cases
    from repro_torch.configs import get_config
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint as ckpt
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dc.replace(get_config(arch), n_layers=layers, dtype=torch.float32)
    cfg = dc.replace(cfg, quoka=dc.replace(cfg.quoka, budget=256))
    card = build_model(cfg, "cuda", seed=0)
    cpu = ckpt.from_flat(ckpt.to_flat(card), cfg, "cpu")
    toks = np.random.default_rng(2).integers(
        3, cfg.vocab, (2, prompt)).astype(np.int32)
    batch = {"tokens": toks, **cases.modality_inputs(cfg, 2)}
    cap = -(-(prompt + cfg.prefix_positions + 8) // 8) * 8
    score, pfs = ops.score, plan_mod.plan_from_scores

    def run(model, b):
        calls, plans = [], []

        def rec_score(qbar, k, valid, **kw):
            out = score(qbar, k, valid, **kw)
            plain = ref.score_ref(qbar.transpose(1, 2), k.transpose(1, 2),
                                  valid)
            calls.append((k[:1].float().clone(), out[:1].clone(),
                          plain[:1].clone(), valid[:1].clone()))
            return out

        def rec_plan(scores, key_pos, cfg, budget=None, heads=None):
            p = pfs(scores, key_pos, cfg, budget=budget, heads=heads)
            plans.append(p.idx[:1].clone())
            return p

        ops.score, plan_mod.plan_from_scores = rec_score, rec_plan
        try:
            with torch.no_grad():
                one = {k: v[:b] for k, v in batch.items()}
                logits, _ = model.prefill(one, model.init_cache(b, cap),
                                          "quoka")
        finally:
            ops.score, plan_mod.plan_from_scores = score, pfs
        return calls, plans, logits.float().cpu()

    c2, p2, l2 = run(card, 2)
    c1, p1, l1 = run(card, 1)
    _, _, lc = run(cpu, 2)
    print(f"{arch} ({layers} layers) fp32, prompt {prompt}, budget 256: "
          f"{len(c1)} scoring calls [{torch.cuda.get_device_name(0)}]")
    for i, ((k1, s1, r1, v1), (k2, s2, r2, _), q1, q2) in enumerate(
            zip(c1, c2, p1, p2)):
        ok = v1[:, None, :].expand_as(s1)
        if not ok.any():
            continue
        dk = float((k1 - k2).abs().max())
        ds = float((s1 - s2)[ok].abs().max())
        slots = int((q1 != q2).sum())
        if dk or ds or slots:
            print(f"  call {i}: keys {dk:.3g} apart, scores {ds:.3g} apart "
                  f"(plain {float((s1 - r1)[ok].abs().max()):.3g} / "
                  f"{float((s2 - r2)[ok].abs().max()):.3g}), plan slots "
                  f"differing {slots}")
    print(f"  first-step logits of row 0: batch 2 vs CPU "
          f"{float((l2[0] - lc[0]).abs().max()):.4g}, batch 1 vs CPU "
          f"{float((l1[0] - lc[0]).abs().max()):.4g} (largest "
          f"{float(lc[0].abs().max()):.4g}); argmax {int(l2[0].argmax())} / "
          f"{int(l1[0].argmax())} / CPU {int(lc[0].argmax())}")


if __name__ == "__main__":
    main(*(a if i == 0 else int(a) for i, a in enumerate(sys.argv[1:])))
