"""Where olmoe-1b-7b's sharded training parts from its meshless run.

olmoe at full width cut to 2 layers, fp32, remat, batch 2 x 256 (the
seed-0 draw and batches of ``chip_smoke.py`` phase 38), two clipped AdamW
steps at ``model=2`` (two ranks sharing the card over gloo) and meshless
on the card.  Prints, for every router call of step 2 (the forward's two
layers, then the recompute's in the backward), the rows whose top-k
experts differ between the mesh's first rank and the meshless run and
the meshless run's margin between its k-th and (k+1)-th probability
there; the capacity dispatch's dropped pairs that differ; how far a 1e-7
relative nudge of the meshless weights moves the meshless steps; and the
mesh against the meshless run on the no-drop twin (capacity factor E /
k).  ~2.5 min on the card:

    python3 tools/moe_route_ties.py          # the card
    python3 tools/moe_route_ties.py cpu      # the smoke config, CPU ranks
"""
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch  # noqa: E402

_ON = [False]


def _record_routes():
    """Patch the MoE's top-k to log (ids, k-th minus (k+1)-th probability)
    of every call while ``_ON[0]``; returns the log."""
    from repro_torch.models import moe
    log, topk = [], moe.topk_stable

    def rec(x, k, dim=-1):
        v, i = topk(x, k, dim)
        if _ON[0]:
            s = torch.sort(x.detach(), dim=-1, descending=True).values
            log.append((i.cpu().numpy(), (s[:, k - 1] - s[:, k]).cpu()
                        .numpy()))
        return v, i
    moe.topk_stable = rec
    return log


def two_steps(model, batches):
    """Two clipped AdamW steps; step 2's router calls and dropped pairs
    recorded.  Returns {"steps", "ids", "drops"} (numpy)."""
    import torch_train_cases as tc
    from repro_torch.models import moe
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import loop
    from repro_torch.training import optimizer as opt
    log = _record_routes()
    state = loop.init_state(model, None)
    params = list(model.parameters())
    ranks, axes = ckpt.leaf_ranks(model), loop.norm_axes(model)
    out = {"steps": []}
    for i, batch in enumerate(batches):
        _ON[0] = i == 1
        moe.DROPS = [] if i == 1 else None
        loss, grads = loop.value_and_grad(model, batch)
        if i == 1:
            out["drops"] = [d.numpy() for d in moe.DROPS]
        _ON[0], moe.DROPS = False, None
        ost, m = opt.apply_updates(params, grads, state.opt, tc.ocfg(0.05),
                                   ranks, axes)
        state = loop.TrainState(model, ost)
        out["steps"].append((float(loss), float(m["grad_norm"])))
    out["ids"] = log
    return out


def rank_body(rank, world, dev, cfgkw, batches):
    torch.set_num_threads(1)
    import torch_train_cases as tc
    from repro_torch.launch.mesh import mesh_from_spec
    mesh = mesh_from_spec("model=2", dev)
    model = tc._model(tc.train_cfg(**cfgkw), None, dev, mesh)
    out = two_steps(model, batches)
    return out if rank == 0 else None


def main(small: bool) -> None:
    import torch_train_cases as tc
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    dev = torch.device("cpu" if small else "cuda")
    cfgkw = dict(arch="olmoe-1b-7b", layers=2, dtype="float32", remat=True,
                 smoke=small)
    if small:      # the smoke config dispatches densely: take capacity
        cfgkw["over"] = {"moe": dataclasses.replace(
            get_config("olmoe-1b-7b").smoke().moe, dispatch="capacity",
            capacity_factor=1.25)}
    cfg = tc.train_cfg(**cfgkw)
    batches = tc.train_batches(cfg, 2, 32 if small else 256, n=2, seed=0)
    mesh = spawn_ranks(rank_body, 2, cfgkw, batches, device=dev.type,
                       timeout=300)[0]
    flat = two_steps(tc._model(cfg, None, dev), batches)
    print(f"capacity factor {cfg.moe.capacity_factor}: steps (loss, gnorm) "
          f"mesh {mesh['steps']} meshless {flat['steps']}")
    for j, ((ia, _), (ib, mb)) in enumerate(zip(mesh["ids"], flat["ids"])):
        diff = (ia != ib).any(-1)
        print(f"  step-2 router call {j}: {int(diff.sum())} of {len(diff)} "
              f"rows route otherwise; meshless margin there "
              f"{mb[diff].tolist()}, smallest anywhere {float(mb.min()):.3e}")
    for j, (da, db) in enumerate(zip(mesh["drops"], flat["drops"])):
        print(f"  step-2 capacity call {j}: {int(db.sum())} pairs dropped "
              f"meshless, {int(da.sum())} on the mesh, "
              f"{int((da != db).sum())} differ")
    del flat
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    base = tc.run_steps(tc._model(cfg, None, dev), batches, 0.05, dev,
                        host=False)
    nudged = tc._model(cfg, None, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for p in nudged.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g, device=dev,
                                          dtype=p.dtype))
    cmp = tc.compare(tc.run_steps(nudged, batches, 0.05, dev, host=False),
                     base)
    print(f"meshless, weights nudged 1e-7, vs meshless: "
          f"{json.dumps(cmp, default=str)}")
    del base, nudged
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    e = cfg.moe
    twin = dict(cfgkw, over={"moe": dataclasses.replace(
        e, capacity_factor=e.n_experts / e.top_k)})
    r = spawn_ranks(tc.train_world, 2,
                    [("twin", ("model=2", twin, None, batches, 0.05),
                      dict(meshless=True))], device=dev.type,
                    timeout=300)[0]["twin"]
    print(f"no-drop twin (capacity factor {e.n_experts / e.top_k}), mesh vs "
          f"meshless: {json.dumps(r['cmp'], default=str)}")
    print(f"took {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:] == ["cpu"])
