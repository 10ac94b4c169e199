"""Rank bodies of the port's sharded-training checks, run by
``launch/mesh.py::spawn_ranks`` from ``tests/test_torch_mesh_train.py``
(on the CPU, gloo), ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
(ranks sharing the card).  Like ``torch_tp_cases.py`` this module imports
neither ``jax`` nor the reference package: the reference's weights
arrive as numpy arguments.

``train_case`` trains one model on a mesh: the loss and every gradient
of the first batch, then AdamW steps (the first on those gradients),
and returns from the mesh's first rank the whole gradients and each
leaf's update (``checkpoint.to_flat`` gathers the shards); with
``meshless=True`` that rank then runs the same steps on the whole model
on its device and returns the comparison (``compare``) instead of the
arrays, so no whole-model array crosses the process boundary."""
import dataclasses
import time

import numpy as np
import torch

LOSS_TOL = 1e-5          # each step's loss and gradient norm, relative
GRAD_TOL = 1e-4          # of each gradient leaf's largest magnitude
UPDATE_TOL = 1e-3        # each leaf's update, relative in L2


def train_cfg(arch, over=None, layers=None, dtype=None, remat=True,
              smoke=True):
    """A config for a training check: the smoke config with ``over`` (or
    the published widths cut to ``layers``), ``dtype`` (a torch dtype's
    name) as the compute dtype, remat on or off."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cfg = cfg.smoke(**(over or {})) if smoke else \
        dataclasses.replace(cfg, **(over or {}))
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype))
    return dataclasses.replace(cfg, remat=remat)


def train_batches(cfg, b, t, n=2, seed=0, mask=False):
    """``n`` numpy batches of ``b`` rows of ``t`` tokens (a VLM's patches
    and whisper's frames beside them; with ``mask``, a ``loss_mask`` that
    keeps about 30% of the positions), from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(
            np.int32)}
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (b, cfg.frontend.n_tokens, cfg.frontend.d_in)).astype(
                    np.float32)
        if cfg.family == "audio":
            batch["frames"] = rng.standard_normal(
                (b, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
        if mask:
            batch["loss_mask"] = (rng.random((b, t)) < 0.3).astype(
                np.float32)
        out.append(batch)
    return out


def ocfg(clip, lr=1e-3):
    from repro_torch.training import optimizer as opt
    return opt.OptimizerConfig(lr=lr, warmup_steps=1, total_steps=10,
                               clip_norm=clip)


def _model(cfg, flat, dev, mesh=None):
    """The reference's weights (``flat``) or, with None, the port's seed-0
    draw, sharded on ``mesh`` when given."""
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint as ckpt
    model = ckpt.from_flat(flat, cfg, dev) if flat is not None else \
        build_model(cfg, dev, seed=0)
    return model if mesh is None else ckpt.shard(model, mesh)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def whole_leaves(model, pick=None, keep=True, to=None):
    """Every leaf of ``model`` whole under the reference's keys (stacked
    leaves stacked), each ``pick(param)`` (default the parameter)
    gathered over the axes that cut it, on the model's device or on
    ``to``: every rank of a mesh calls it (the gathers are collectives);
    ``keep=False`` drops what it gathers (a rank that compares
    nothing)."""
    from repro_torch.training.checkpoint import _whole, leaf_map
    pick = pick or (lambda p: p)
    out = {}
    with torch.no_grad():
        for key, (ts, stacked) in leaf_map(model).items():
            ws = [_whole(model, t, pick(t)).detach() for t in ts]
            if keep:
                w = torch.stack(ws) if stacked else ws[0].clone()
                out[key] = w if to is None else w.to(to)
    return out


def run_steps(model, batches, clip, dev, keep=True, host=True, lr=1e-3,
              before=True, gather=("grads", "updates")):
    """The loss and gradients of ``batches[0]``, then one AdamW step per
    batch (the first on those gradients).  Returns {"loss", "grads"
    (whole, by the reference's keys), "steps" [(loss, grad norm)],
    "before" and "updates" (after - before; with ``before=False`` in
    their place "after", the whole leaves after the steps: the caller
    takes those before them from a meshless run of the same draw),
    "step_s", "bytes" (each step's collective bytes by (scope, kind)),
    "state" (the ``TrainState``)}, the whole arrays only of what
    ``gather`` names ("grads", "updates"); every rank of a mesh calls it
    (the whole leaves are gathered; ``keep=False`` keeps none of them).
    The whole leaves go to host memory as they are gathered, so the
    device holds only what training holds: numpy arrays with ``host``,
    else CPU tensors."""
    from repro_torch.sharding import comm
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import loop
    from repro_torch.training import optimizer as opt
    state = loop.init_state(model, None)
    params = list(model.parameters())
    index = {p: i for i, p in enumerate(params)}
    ranks, axes = ckpt.leaf_ranks(model), loop.norm_axes(model)
    out = {"steps": [], "step_s": [], "bytes": [], "walls": {}}
    before = before and "updates" in gather
    if before:
        t0 = _sync(dev)
        out["before"] = whole_leaves(model, keep=keep, to="cpu")
        out["walls"]["gather before"] = _sync(dev) - t0
    cfg = ocfg(clip, lr)
    for i, batch in enumerate(batches):
        comm.reset_counts()
        t0 = _sync(dev)
        loss, grads = loop.value_and_grad(model, batch)
        ost, m = opt.apply_updates(params, grads, state.opt, cfg, ranks,
                                   axes)
        state = loop.TrainState(model, ost)
        out["step_s"].append(_sync(dev) - t0)
        out["bytes"].append(dict(comm.BYTES))
        out["steps"].append((float(loss), float(m["grad_norm"])))
        if i == 0:
            out["loss"] = float(loss)
        if i == 0 and "grads" in gather:
            t0 = _sync(dev)
            out["grads"] = whole_leaves(model, lambda p: grads[index[p]],
                                        keep, to="cpu")
            out["walls"]["gather grads"] = _sync(dev) - t0
        del grads
    if "updates" in gather:
        t0 = _sync(dev)
        out["after"] = whole_leaves(model, keep=keep, to="cpu")
        out["walls"]["gather after"] = _sync(dev) - t0
    if before:
        out["updates"] = {k: v - out["before"][k]
                          for k, v in out.pop("after").items()}
    if host:
        for name in ("grads", "updates", "before", "after"):
            if name in out:
                out[name] = {k: v.numpy() for k, v in out[name].items()}
    out["state"] = state
    return out


def _as(x, dev=None):
    """``x`` (numpy or a tensor) as a float64 tensor on ``dev`` (default
    where it is)."""
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))
    return (x if dev is None else x.to(dev)).double()


def _rel(a, b):
    return abs(a - b) / abs(b) if b else abs(a)


def compare(got, want, dev=None):
    """The errors of a mesh run against a meshless one (``run_steps``'
    results, numpy or CPU tensors): the first loss's and every step's
    loss and grad norm relative error, each gradient leaf's error
    relative to its largest magnitude (the worst leaf, and the leaves the
    mesh left zero where the meshless run has a gradient), each leaf's
    update's relative L2 error (the worst leaf), the last two where both
    runs gathered them; in float64, leaf by leaf on ``dev`` (default the
    CPU)."""
    out = {"loss": _rel(got["loss"], want["loss"]),
           "steps": [max(_rel(a, c), _rel(b, d)) for (a, b), (c, d)
                     in zip(got["steps"], want["steps"])]}
    if "updates" in got and "updates" in want:
        out["update"] = _worst_l2(got["updates"], want["updates"], dev=dev)
    if "grads" not in got or "grads" not in want:
        return out
    worst, zero = ("", 0.0), []
    for k, w in want["grads"].items():
        w, g = _as(w, dev), _as(got["grads"][k], dev)
        top = float(w.abs().max())
        err = float((g - w).abs().max())
        err = err / top if top > 0 else err
        if err > worst[1] or not worst[0]:
            worst = (k, err)
        if top > 0 and not float(g.abs().max()) > 0:
            zero.append(k)
    out["grad"], out["zero"] = worst, zero
    return out


def _worst_l2(got, want, base=None, dev=None):
    """The leaf whose ``got`` is farthest from ``want`` relative to
    ``want`` (or to ``want - base``) in L2, and that error (float64, on
    ``dev``)."""
    worst = ("", 0.0)
    for k, w in want.items():
        w, g = _as(w, dev), _as(got[k], dev)
        den = float(torch.linalg.vector_norm(
            w if base is None else w - _as(base[k], dev)))
        err = float(torch.linalg.vector_norm(g - w))
        err = err / den if den > 0 else err
        if err > worst[1] or not worst[0]:
            worst = (k, err)
    return worst


def check(cmp, grad_tol=GRAD_TOL, what=""):
    """Raise unless ``compare``'s errors (and ``train_case``'s MoE
    ``aux`` and ``drops``, where it compared them) are within the
    bounds."""
    if cmp["loss"] > LOSS_TOL or max(cmp["steps"]) > LOSS_TOL:
        raise AssertionError(f"{what}: loss / grad norm {cmp}")
    if "grad" in cmp and (cmp["grad"][1] > grad_tol or cmp["zero"]):
        raise AssertionError(f"{what}: gradients {cmp['grad']}, "
                             f"zero {cmp['zero'][:4]}")
    if "update" in cmp and cmp["update"][1] > UPDATE_TOL:
        raise AssertionError(f"{what}: updates {cmp['update']}")
    if cmp.get("aux", 0.0) > LOSS_TOL or cmp.get("drops", {}).get("differ"):
        raise AssertionError(f"{what}: aux loss {cmp['aux']}, dropped "
                             f"pairs {cmp['drops']}")


def _drops_and_aux(model, batch, rows):
    """The capacity dispatch's dropped pairs (one (N, k) mask a MoE call)
    and the aux loss of a forward pass over ``batch`` (no backward)."""
    from repro_torch.models import moe
    moe.DROPS = []
    try:
        with torch.no_grad():
            _, aux = model.train_logits(batch, rows)
        return [d.numpy() for d in moe.DROPS], float(aux)
    finally:
        moe.DROPS = None


def state_errors(path, cfg, dev, want, before):
    """``restore_state`` of the file at ``path`` (meshless, on ``dev``)
    against the ``TrainState`` ``want``: the worst leaf's parameter
    update (from the whole leaves ``before``), first and second moments,
    each relative in L2, and whether the steps agree."""
    from repro_torch.training import checkpoint as ckpt
    model, ost = ckpt.restore_state(path, cfg, dev)
    got = {"params": whole_leaves(model)}
    ref = {"params": whole_leaves(want.model)}
    for name in ("mu", "nu"):
        for tree, (m, st) in ((got, (model, ost)), (ref, (want.model,
                                                         want.opt))):
            index = {p: i for i, p in enumerate(m.parameters())}
            ms = getattr(st, name)
            tree[name] = whole_leaves(m, lambda p: ms[index[p]])
    worst = max((_worst_l2(got[n], ref[n], before if n == "params"
                           else None, dev) for n in got),
                key=lambda w: w[1])
    return {"worst": worst, "step": int(ost.step) == int(want.opt.step),
            "keys": set(got["params"]) == set(ref["params"])}


def train_case(rank, world, dev, spec, cfgkw, flat, batches, clip,
               meshless=False, drops=False, generate=False, save=None,
               lr=1e-3, gather=("grads", "updates")):
    """Train on the mesh ``spec`` (``train_cfg(**cfgkw)``; the weights
    ``flat``, or the port's seed-0 draw with None) over ``batches``
    (``run_steps``, gathering what ``gather`` names).  Returns from the
    mesh's first rank ``run_steps``' result with each step's wall and
    bytes and the rank's peak GiB, and: ``drops`` the MoE's dropped pairs
    of a forward pass (this rank's rows) and its aux loss; ``generate``
    the bytes of a ``generate`` on the trained sharded model by scope
    (none under ``grad`` or ``remat``); ``meshless`` the comparison with
    the same steps on the whole model on this device (``compare``; with
    ``drops`` also the aux loss's relative error and the dropped pairs
    that differ from the meshless run's first rows) in place of the
    arrays, with its step walls and peak, and with ``save`` (a path) the
    sharded state saved there and read back meshless against the
    meshless run's (``state_errors``).  Every rank also returns its
    backend and the kernel launches of its steps (the training forward
    runs no kernel); the other ranks their byte counts, walls and peaks
    besides."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.sharding import comm
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import loop
    mesh = mesh_from_spec(spec, dev)
    cfg = train_cfg(**cfgkw)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    from torch_tp_cases import _launches, _zero_launches
    t0 = _sync(dev)
    model = _model(cfg, flat, dev, mesh)
    out = {"backend": comm.axis(mesh).backend,
           "walls": {"build": _sync(dev) - t0}}
    _zero_launches()
    if drops:
        local, rows = loop.local_batch(model, batches[0])
        out["drops"], out["aux"] = _drops_and_aux(model, local, rows)
    first = comm.seed(mesh) == 1.0
    # beside a meshless run its leaves before the steps stand for the
    # mesh's: the mesh's shards are slices of the same seed-0 draw
    run = run_steps(model, batches, clip, dev, keep=first,
                    host=not meshless, lr=lr, before=not meshless,
                    gather=gather)
    run.pop("before", None)
    out["walls"].update(run.pop("walls"))
    out["launches"] = _launches()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if cuda else None
    if generate:
        from repro_torch.serving.engine import Engine
        eng = Engine(model, method="quoka", device=dev, mesh=mesh)
        comm.reset_counts()
        eng.generate(eng.pad_prompt(batches[0]["tokens"][:2, :16]), 2)
        out["generate_bytes"] = {s for s, _ in comm.BYTES}
    if save is not None:
        t0 = _sync(dev)
        ckpt.save(save, run["state"])
        dist.barrier()
        out["walls"]["save"] = _sync(dev) - t0
    del model, run["state"]
    if not first:
        return {k: run[k] for k in ("step_s", "bytes")} | out
    if not meshless:
        return run | out
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = _sync(dev)
    whole = _model(cfg, flat, dev)
    if drops:
        want_drops, want_aux = _drops_and_aux(whole, batches[0], None)
    want = run_steps(whole, batches, clip, dev, host=False, lr=lr,
                     gather=gather)
    del whole
    out["meshless_peak_gib"] = torch.cuda.max_memory_allocated(dev) \
        / 2 ** 30 if cuda else None
    out["meshless_step_s"] = want["step_s"]
    if "after" in run:
        run["updates"] = {k: v - want["before"][k]
                          for k, v in run.pop("after").items()}
    out["cmp"] = compare(run, want, dev)
    if drops:
        # the first rank's rows are the batch's first: its tokens lead
        # every MoE call's (N, k) mask
        out["cmp"]["aux"] = _rel(out["aux"], want_aux)
        out["cmp"]["drops"] = {
            "calls": [len(out["drops"]), len(want_drops)],
            "meshless": sum(int(d.sum()) for d in want_drops),
            "differ": sum(int((g != w[:len(g)]).sum()) for g, w
                          in zip(out["drops"], want_drops))
            + abs(len(out["drops"]) - len(want_drops))}
    out.update({k: run[k] for k in ("steps", "step_s", "bytes")})
    out["meshless_steps"] = want["steps"]
    out["walls"]["meshless and compare"] = _sync(dev) - t0
    del run
    if save is not None:
        t0 = _sync(dev)
        out["saved"] = state_errors(save, cfg, dev, want["state"],
                                    want["before"])
        out["walls"]["read back"] = _sync(dev) - t0
    return out


def train_world(rank, world, dev, runs):
    """One spawn: each (name, args, kwargs) of ``runs`` through
    ``train_case``, in order.  Returns {name: result}."""
    return {name: train_case(rank, world, dev, *args, **kw)
            for name, args, kw in runs}


def launcher_case(rank, world, dev, argv):
    """``launch/train.py``'s ``main(argv)`` on this rank, its standard
    output captured.  Returns (what it printed, its losses)."""
    import contextlib
    import io
    torch.set_num_threads(1)
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = train.main(argv)
    return buf.getvalue(), run.losses


def resume_case(rank, world, dev, spec, cfgkw, flat, batches, clip, path):
    """One AdamW step on the mesh, ``save`` of the sharded state (rank 0
    writes), ``restore_state`` then ``shard`` of what it wrote, and the
    next step from it and from the state in memory.  Returns {"steps":
    (the next step's loss and grad norm resumed, in memory),
    "host_copies": the whole leaves ``save`` copied to host memory on
    this rank}."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import loop
    mesh = mesh_from_spec(spec, dev)
    cfg = train_cfg(**cfgkw)
    model = _model(cfg, flat, dev, mesh)
    step = loop.make_train_step(model, ocfg(clip))
    state, _ = step(loop.init_state(model, None), batches[0])
    copies, numpy = [0], ckpt._numpy

    def counted(t):
        copies[0] += 1
        return numpy(t)
    ckpt._numpy = counted
    try:
        ckpt.save(path, state)
    finally:
        ckpt._numpy = numpy
    dist.barrier()
    m2, ost = ckpt.restore_state(path, cfg, dev)
    ckpt.shard(m2, mesh, state=ost)
    out = []
    for st in (loop.TrainState(m2, ost), state):
        _, met = loop.make_train_step(st.model, ocfg(clip))(st, batches[1])
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return {"steps": out, "host_copies": copies[0]}


def extra_world(rank, world, dev, spec, cfgkw, flat, batches, clip, path,
                argv):
    """``resume_case``, then ``launcher_case`` (whose exit leaves the
    process group, so it comes last)."""
    resumed = resume_case(rank, world, dev, spec, cfgkw, flat, batches,
                          clip, path)
    return resumed, launcher_case(rank, world, dev, argv)


def row_partial_grad_errors(dev, n=256, k=512, m=384, seed=0):
    """``layers.row_partial``'s card route (one bf16 GEMM with an fp32
    result) under autograd against the same product in fp32: the
    product's and both gradients' largest errors, each relative to the
    fp32 one's largest magnitude (bf16 rounding of the inputs and of the
    backward's GEMMs is all that should part them)."""
    from repro_torch.models.layers import row_partial
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(2, n // 2, k, generator=gen, device=dev)
    w = torch.randn(k, m, generator=gen, device=dev) / k ** 0.5
    r = torch.randn(2, n // 2, m, generator=gen, device=dev)
    out = {}
    for name, dt in (("got", torch.bfloat16), ("want", torch.float32)):
        xs = x.to(dt).requires_grad_(True)
        ws = w.to(dt).requires_grad_(True)
        y = row_partial(ws, xs)
        gx, gw = torch.autograd.grad((y * r).sum(), (xs, ws))
        out[name] = (y.detach().float(), gx.float(), gw.float())
    return {k: float((a - b).abs().max() / b.abs().max())
            for k, a, b in zip(("product", "grad x", "grad w"),
                               out["got"], out["want"])}
