"""``chip_smoke.py``'s ``main()`` of the tree at ROOT from phase 14 on.

Phases 14-35 need only the kernels' build from what comes before them,
so this skips phases 1-13 (about 40% of a whole run) and stops before the
kernel line, which reads them.  Phase 16 runs PASSES times (default 1).
A development check on the card, not a substitute for the whole script:

    python3 tools/chip_smoke_tail.py ROOT [PASSES]
    python3 tools/chip_smoke_tail.py ROOT --phase36   # the build, phase 36
    python3 tools/chip_smoke_tail.py ROOT --phase37   # the build, phase 37
    python3 tools/chip_smoke_tail.py ROOT --phase38   # the build, phase 38

(``--phase33``, ``--phase36``, ``--phase37`` and ``--phase38`` may be
given together: the build, then each phase in the order given.)
"""
import inspect, os, sys, textwrap


def main(root, passes=1):
    sys.path.insert(0, root); sys.path.insert(0, os.path.join(root, "src"))
    import chip_smoke as cs
    src = textwrap.dedent(inspect.getsource(cs.main))
    a = src.index('    log("== phase 1: build")')
    b = src.index('    llama, oneshot = phase_oneshot(')
    c = src.index('    launches = {"quoka_score"')
    head = '    build.library()\n    timing = {"flash_attention": {}}\n' \
           '    errs = {"quoka_score": 0.0, "flash_attention": 0.0}\n'
    mid = src[b:c].replace(
        "    tier = phase_host_tier(torch, np, K, llama)\n",
        "    tier = phase_host_tier(torch, np, K, llama)\n"
        f"    for _ in range({passes - 1}):\n"
        "        phase_host_tier(torch, np, K, llama)\n")
    tail = '    log(f"phase wall times (s): {json.dumps(phase_walls())}")\n' \
           '    return 0\n'
    ns = dict(vars(cs))
    exec(compile(src[:a] + head + mid + tail, "main_tail", "exec"), ns)
    return ns["main"]()


def mesh_phases(root, names):
    """The kernels' build, then mesh phases alone, in order: each a
    function of ``chip_smoke.py`` (``phase_mesh``, ``phase_kinds``,
    ``phase_modality_mesh``, ``phase_train_mesh``)."""
    sys.path.insert(0, root); sys.path.insert(0, os.path.join(root, "src"))
    import chip_smoke as cs
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quoka_score as qs
    from repro_torch.kernels import ref
    from repro_torch.kernels import selected_attention as sa
    K = {"flash": fa, "score": qs, "selected": sa, "ref": ref}
    build.library()
    dev = torch.device("cuda", torch.cuda.current_device())
    card = cs.card_line()
    for name in names:
        out = getattr(cs, name)(torch, np, K, card, dev)
        if isinstance(out, tuple):
            cs.log(f"kernel errors {out[1]}")
        torch.cuda.empty_cache()
    cs.log(f"phase wall times (s): {cs.json.dumps(cs.phase_walls())}")
    cs.log(card)
    return 0


PHASES = {"--phase33": "phase_mesh", "--phase36": "phase_kinds",
          "--phase37": "phase_modality_mesh", "--phase38": "phase_train_mesh"}

if __name__ == "__main__":
    if sys.argv[2:3] and sys.argv[2] in PHASES:
        sys.exit(mesh_phases(sys.argv[1], [PHASES[a] for a in sys.argv[2:]]))
    sys.exit(main(sys.argv[1], *(int(x) for x in sys.argv[2:3])))
