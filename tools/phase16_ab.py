"""Phase 16's slab-copy check, repeated, with what its trace recorded.

Runs ``chip_smoke.py``'s ``main()`` of the tree at ROOT up to phase 15,
then phase 16 (the host tier) PASSES times, taking a warm-up kernel,
fetch and sleep out of the ``[B, A]`` profiler session where a tree has
them, and prints, per pass, the check's verdict and what the trace
recorded: kernels on the
compute stream in the first three steps, the first recorded kernel, and
how far the first slab copy starts after its step's first recorded
kernel (us; negative: before it).  To compare two commits, unpack the
other one (``git archive``) into a git-ignored directory and run both
in one call on the card:

    python3 tools/phase16_ab.py ROOT TAG PASSES
"""
import bisect, inspect, json, math, os, sys, textwrap


def stats(path):
    ev = json.load(open(path))["traceEvents"]
    kern = [e for e in ev if e.get("cat") == "kernel"]
    streams = {}
    for e in kern:
        streams[e["args"]["stream"]] = streams.get(e["args"]["stream"], 0) + 1
    compute = max(streams, key=streams.get)
    on = sorted((k["ts"], k["ts"] + k["dur"], k["name"][:40]) for k in kern
                if k["args"]["stream"] == compute)
    starts = [k[0] for k in on]
    fetches = sorted(e["ts"] for e in ev if e.get("cat") == "gpu_memcpy"
                     and "DtoH" in e.get("name", "")
                     and "Pageable" in e["name"]
                     and e["args"]["stream"] == compute)
    per_step = []
    edges = [-math.inf] + fetches + [math.inf]
    for a, b in zip(edges, edges[1:4]):
        per_step.append(bisect.bisect_left(starts, b)
                        - bisect.bisect_right(starts, a))
    sz = {}
    for e in ev:
        if e.get("cat") == "gpu_memcpy" and "HtoD (Pinned" in e.get("name", ""):
            sz[e["args"]["bytes"]] = sz.get(e["args"]["bytes"], 0) + 1
    slab = max(sz, key=sz.get) if sz else -1
    copies = sorted(e["ts"] for e in ev if e.get("cat") == "gpu_memcpy"
                    and e.get("args", {}).get("bytes") == slab
                    and "HtoD" in e.get("name", ""))
    first = None
    if copies:
        lo = copies[0]
        f = bisect.bisect_left(fetches, lo)
        f0 = fetches[f - 1] if f > 0 else -math.inf
        step = on[bisect.bisect_right(starts, f0):]
        first = (f, round(lo - step[0][0], 1) if step else None,
                 step[0][2] if step else None)
    return dict(kernels_first_steps=per_step, first_kernel=on[0][2] if on
                else None, first_copy=first, n_copies=len(copies))


def main(root, tag, passes):
    sys.path.insert(0, root); sys.path.insert(0, os.path.join(root, "src"))
    import torch
    import chip_smoke as cs
    orig = torch.profiler.profile.export_chrome_trace
    seen = []

    def export(self, path):
        r = orig(self, path)
        if path.endswith("tier.json"):
            seen.append(stats(path))
        return r

    torch.profiler.profile.export_chrome_trace = export
    ns = dict(vars(cs))
    tier = textwrap.dedent(inspect.getsource(cs.phase_host_tier))
    for line in ("torch.ones(1, device=model.device).add_(1).cpu()",
                 "time.sleep(0.05)"):
        tier = "\n".join(l for l in tier.split("\n")
                         if l.strip() != line)
    exec(compile(tier, "tier_nowarm", "exec"), ns)
    src = textwrap.dedent(inspect.getsource(cs.main))
    cut = src.index("    tier = phase_host_tier(torch, np, K, llama)")
    body = src[:cut] + textwrap.indent(textwrap.dedent('''
        for i in range(passes):
            try:
                phase_host_tier(torch, np, K, llama)
                print("RESULT", tag, i, "pass", seen[-1], flush=True)
            except AssertionError as e:
                print("RESULT", tag, i, "fail", e, seen[-1] if seen else None,
                      flush=True)
        return 0
        '''), "    ")
    ns.update(passes=passes, tag=tag, seen=seen)
    exec(compile(body, "main_cut", "exec"), ns)
    ns["main"]()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]))
