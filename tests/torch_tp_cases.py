"""Rank bodies of the port's mesh checks, run by
``launch/mesh.py::spawn_ranks`` from ``tests/test_torch_sharding.py``,
``tests/test_torch_dp.py`` and ``tests/test_torch_ep.py`` (on the CPU,
gloo), ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (ranks sharing
the card).  This module imports
neither ``jax`` nor the reference package: the reference's weights and
expected outputs arrive as numpy arguments."""
import dataclasses
import math

import numpy as np
import torch

SERVE_KW = dict(block_size=16, max_decode_batch=4, max_prefill_tokens=32)
GEN_NEW = 8


def port_cfg(arch, over, quoka=None):
    from repro_torch.configs import get_config
    cfg = get_config(arch).smoke(**over)
    if quoka:
        cfg = dataclasses.replace(cfg, quoka=dataclasses.replace(
            cfg.quoka, **quoka))
    return cfg


def _models(cfg, flat, dev, mesh):
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint as ckpt
    if flat is None:                    # the port's own seeded weights
        return build_model(cfg, dev, seed=0), build_model(cfg, dev, seed=0)
    return (ckpt.from_flat(flat, cfg, dev),
            ckpt.from_flat(flat, cfg, dev, mesh=mesh))


def serve_case(rank, world, dev, arch, over, flat, prompts, quoka=None,
               new=GEN_NEW, spec=None, meshless=True):
    """generate (two prompts, ``new`` new tokens), a serve trace and the same
    trace again over the warm pool, meshless and on a ``model=world``
    mesh (or the mesh ``spec``), for ``full`` and ``quoka``.  Returns
    every token array, the scoring routes, the scoring collectives' bytes
    per T-local call beside the K cache's bytes per layer call, whether
    every sharded leaf reassembles to the meshless model's, the parameter
    bytes this rank holds beside what its placements give it (before and
    after serving), and the FSDP gathers' bytes and the layer stacks'
    calls of the mesh ``generate``.  ``meshless=False`` leaves the
    meshless runs to the caller."""
    torch.set_num_threads(1)
    from repro_torch.core import quoka as qk
    from repro_torch.launch.mesh import make_host_mesh, mesh_from_spec
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import make_requests
    from repro_torch.sharding import comm
    from repro_torch.training.checkpoint import leaf_map
    mesh = make_host_mesh(model=world) if dev.type == "cpu" and not spec \
        else mesh_from_spec(spec or f"model={world}", dev)
    cfg = port_cfg(arch, over, quoka)
    out = {"backend": comm.axis(mesh).backend}
    toks = np.stack([prompts[1], prompts[1][::-1].copy()])
    for method in ("full", "quoka"):
        full, shd = _models(cfg, flat, dev, mesh)
        ref = Engine(full, method=method, device=dev)
        eng = Engine(shd, method=method, device=dev, mesh=mesh)
        if method == "full":
            out["reassembled"] = _reassembled(full, shd, mesh, leaf_map)
            out["param_bytes"] = param_bytes(full, shd, mesh)
        calls = _count_calls(shd)
        if meshless:
            out[f"{method}/generate"] = ref.generate(ref.pad_prompt(toks),
                                                     new).tokens
        for k in list(qk.ROUTES):
            qk.ROUTES[k] = 0
        comm.reset_counts()
        out[f"{method}/generate_mesh"] = eng.generate(
            eng.pad_prompt(toks), new).tokens
        out[f"{method}/routes"] = dict(qk.ROUTES)
        out[f"{method}/score_bytes"] = comm.bytes_by_kind("score")
        out[f"{method}/fsdp_bytes"] = comm.bytes_by_kind("fsdp")
        out[f"{method}/stack_calls"] = calls[0]
        if meshless:
            out[f"{method}/serve"] = ref.serve(make_requests(prompts, 5),
                                               **SERVE_KW).tokens
        st = eng.make_serve_state(make_requests(prompts, 5), **SERVE_KW)
        out[f"{method}/serve_mesh"] = eng.serve(make_requests(prompts, 5),
                                                state=st).tokens
        out[f"{method}/serve_hit"] = eng.serve(make_requests(prompts, 5),
                                               state=st).tokens
        out[f"{method}/cache_hits"] = eng.stats["cache_hits"]
        out[f"{method}/pool_blocks"] = (st.pool.local_blocks,
                                        st.pool.num_blocks)
        if method == "full":
            out["param_bytes_after"] = param_bytes(full, shd, mesh)[0]
    hd = cfg.resolved_head_dim
    cap = toks.shape[1] + new
    out["k_bytes"] = toks.shape[0] * cap * cfg.n_kv_heads * hd * 4
    return out


def _placed(full, mesh):
    """(flat key -> its placement without a stacked leaf's repeats entry,
    the model axis, the FSDP axis)."""
    from repro_torch.sharding import comm, specs
    from repro_torch.training.checkpoint import leaf_map
    place = specs.param_specs(full.cfg, specs.tree_shapes(full), mesh)
    spec = {k: place[k][int(stacked):]
            for k, (_, stacked) in leaf_map(full).items()}
    return spec, comm.axis(mesh), comm.axis(mesh, specs.fsdp_axes(mesh)
                                            or ())


def _reassembled(full, shd, mesh, leaf_map):
    """Every leaf of the sharded model, gathered over the FSDP and model
    axes where its placement cut it, equals the meshless model's."""
    from repro_torch.sharding import comm, specs
    spec, ax, fax = _placed(full, mesh)
    fl, sl = leaf_map(full), leaf_map(shd)
    for key, (fts, _) in fl.items():
        for ft, st in zip(fts, sl[key][0]):
            for dim, a in ((specs.fsdp_axis_entry(spec[key]), fax),
                           (specs.model_axis_entry(spec[key]), ax)):
                if dim is not None and a.size > 1:
                    st = comm.all_gather(st, a, dim)
            if not torch.equal(ft, st):
                return False
    return True


def param_bytes(full, shd, mesh):
    """(parameter bytes the sharded model holds, the bytes its
    placements give this rank: each leaf over the sizes of the axes that
    cut it, the whole model's bytes)."""
    from repro_torch.sharding import specs
    from repro_torch.training.checkpoint import leaf_map
    spec, ax, fax = _placed(full, mesh)
    held = sum(p.numel() * p.element_size() for p in shd.parameters())
    want = whole = 0
    for key, (ts, _) in leaf_map(full).items():
        n = sum(t.numel() * t.element_size() for t in ts)
        whole += n
        for dim, a in ((specs.fsdp_axis_entry(spec[key]), fax),
                       (specs.model_axis_entry(spec[key]), ax)):
            if dim is not None:
                n //= a.size
        want += n
    return held, want, whole


def _count_calls(model):
    """A one-element list counting ``model``'s layer-stack passes."""
    calls, inner = [0], model._apply_stacks

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    model._apply_stacks = counted
    return calls


def seq_case(rank, world, dev, spec, arch, over, flat, prompt, method,
             quoka=None, new=GEN_NEW, record=False, meshless=True):
    """A batch-1 ``generate`` of ``prompt`` (tokens) meshless and on the
    mesh ``spec``, whose cache capacity the ``data`` axis divides, so the
    cache's sequence splits over ``data``.  Returns both token arrays,
    the scoring routes, the selecting calls' ``score`` and ``seq`` bytes
    (and all bytes by scope), the slots each layer's cache holds here and
    the capacity; with ``record``, every selecting layer call's inputs
    (whole, gathered under a scope of their own) and plan ids of the
    measured run, from rank 0 (the plans are equal on every rank).
    ``meshless=False`` leaves the meshless run to the caller."""
    torch.set_num_threads(1)
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import quoka as qk
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.serving.engine import Engine
    from repro_torch.sharding import comm
    mesh = mesh_from_spec(spec, dev)
    cfg = port_cfg(arch, over, quoka)
    full, shd = _models(cfg, flat, dev, mesh)
    toks = prompt[None]
    ref = Engine(full, method=method, device=dev)
    eng = Engine(shd, method=method, device=dev, mesh=mesh)
    out = {"generate": ref.generate(ref.pad_prompt(toks), new).tokens
           if meshless else None}
    caches, records, runs = [], [], [0]
    init_cache, prefill, build = (shd.init_cache, shd.prefill,
                                  plan_mod.build)

    def init(*a, **kw):
        caches.append(init_cache(*a, **kw))
        return caches[-1]

    def pre(*a, **kw):
        runs[0] += 1
        return prefill(*a, **kw)

    def rec(method, q, k, key_pos, chunk_start, cfg, budget=None,
            q_valid=None, heads=None, seq=None, sketch=None):
        pln = build(method, q, k, key_pos, chunk_start, cfg, budget=budget,
                    q_valid=q_valid, heads=heads, seq=seq, sketch=sketch)
        if record and runs[0] == 2 and seq is not None:
            with comm.scope("record"):
                if heads.heads_sharded:
                    q = comm.all_gather(q, heads.ax, 2)
                idx = pln.idx
                if heads.kv_sharded and idx.ndim == 3:
                    idx = comm.all_gather(idx, heads.ax, 1)
                whole = [comm.all_gather(x, seq.ax, 1) for x in (k, key_pos)]
                if heads.kv_sharded:
                    whole[0] = comm.all_gather(whole[0], heads.ax, 2)
            if rank == 0:
                records.append(dict(
                    q=q.numpy(), k=whole[0].numpy(), key_pos=whole[1].numpy(),
                    chunk_start=int(chunk_start), budget=budget,
                    q_valid=None if q_valid is None else q_valid.numpy(),
                    idx=idx.numpy()))
        return pln

    shd.init_cache, shd.prefill, plan_mod.build = init, pre, rec
    for key in qk.ROUTES:
        qk.ROUTES[key] = 0
    comm.reset_counts()
    try:
        out["generate_mesh"] = eng.generate(eng.pad_prompt(toks), new).tokens
    finally:
        plan_mod.build = build
    kv = caches[-1][0][0]
    out.update(routes=dict(qk.ROUTES), records=records,
               bytes={s: comm.bytes_by_kind(s)
                      for s in ("score", "seq", "fsdp", "")},
               slots=[c.k.shape[1] for st in caches[-1] for c in st],
               cap=kv.capacity, k_bytes=kv.capacity * cfg.n_kv_heads
               * cfg.resolved_head_dim * kv.k.element_size(),
               budget_bytes=_budget_bytes(kv, cfg.quoka))
    return out


def _budget_bytes(kv, qcfg):
    """The bytes of one selection budget's K, V and position rows of the
    KV heads the sequence-sharded cache ``kv`` holds here."""
    from repro_torch.core import plan as plan_mod
    b, _, n_kv, hd = kv.k.shape
    row = 2 * hd * kv.k.element_size() + kv.pos.element_size()
    return plan_mod.resolve_budget(qcfg, kv.capacity) * b * n_kv * row


def gen_case(rank, world, dev, spec, arch, over, flat, toks, new=GEN_NEW,
             meshless=True):
    """``generate`` of the batch ``toks`` for ``full`` and ``quoka``,
    meshless (unless ``meshless`` is False) and on the mesh ``spec``:
    {method: (meshless or None, mesh)}."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.serving.engine import Engine
    mesh = mesh_from_spec(spec, dev)
    cfg = port_cfg(arch, over)
    out = {}
    for method in ("full", "quoka"):
        full, shd = _models(cfg, flat, dev, mesh)
        ref = Engine(full, method=method, device=dev)
        eng = Engine(shd, method=method, device=dev, mesh=mesh)
        out[method] = (ref.generate(ref.pad_prompt(toks), new).tokens
                       if meshless else None,
                       eng.generate(eng.pad_prompt(toks), new).tokens)
    return out


def ep_case(rank, world, dev, spec, arch, over, flat, toks, new=GEN_NEW,
            serve=None, record=False):
    """The expert-parallel MoE and MLA checks of one mesh ``spec``:
    ``generate`` of the batch ``toks`` (``new`` new tokens) with QUOKA
    on the mesh, each capacity call's dropped-pair mask (this rank's
    rows, ``moe.DROPS``), the scoring routes, the bytes by scope, the
    slots each layer's cache holds, the experts and the parameter bytes
    this rank holds beside its placements', whether the shards
    reassemble; with ``serve`` (prompts) a serve over a fresh pool and
    the same requests again over the warm one (a prefix hit), their
    tokens, hits and drops; with ``record``, every selecting layer call's
    inputs (the queries of every head) and plan ids, from rank 0."""
    torch.set_num_threads(1)
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import quoka as qk
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.models import moe
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import make_requests
    from repro_torch.sharding import comm
    from repro_torch.training.checkpoint import leaf_map
    mesh = mesh_from_spec(spec, dev)
    cfg = port_cfg(arch, over)
    full, shd = _models(cfg, flat, dev, mesh)
    eng = Engine(shd, method="quoka", device=dev, mesh=mesh)
    out = {"reassembled": _reassembled(full, shd, mesh, leaf_map),
           "param_bytes": param_bytes(full, shd, mesh),
           "experts": sorted({blk.moe.gate.shape[0] for blk in shd.layers()
                              if hasattr(blk, "moe")})}
    del full
    caches, records = [], []
    init_cache, build = shd.init_cache, plan_mod.build

    def init(*a, **kw):
        caches.append(init_cache(*a, **kw))
        return caches[-1]

    def rec(method, q, k, key_pos, chunk_start, cfg, budget=None,
            q_valid=None, heads=None, seq=None, sketch=None):
        pln = build(method, q, k, key_pos, chunk_start, cfg, budget=budget,
                    q_valid=q_valid, heads=heads, seq=seq, sketch=sketch)
        if record and seq is None:
            with comm.scope("record"):
                if heads.heads_sharded:
                    q = comm.all_gather(q, heads.ax, 2)
            if rank == 0:
                records.append(dict(
                    q=q.numpy(), k=k.numpy(), key_pos=key_pos.numpy(),
                    chunk_start=int(chunk_start), budget=budget,
                    q_valid=None if q_valid is None else q_valid.numpy(),
                    idx=pln.idx.numpy()))
        return pln

    eng.generate(eng.pad_prompt(toks), new)          # warm the signature
    shd.init_cache, plan_mod.build = init, rec
    for key in qk.ROUTES:
        qk.ROUTES[key] = 0
    comm.reset_counts()
    moe.DROPS = []
    try:
        out["generate"] = eng.generate(eng.pad_prompt(toks), new).tokens
        out["drops"] = [d.numpy() for d in moe.DROPS]
    finally:
        plan_mod.build, moe.DROPS = build, None
        del shd.init_cache
    lay = caches[-1][0][0]
    out.update(routes=dict(qk.ROUTES), records=records,
               bytes={sc: comm.bytes_by_kind(sc)
                      for sc in ("ep", "score", "seq", "fsdp", "")},
               slots=(lay.pos.shape[1], lay.capacity))
    if serve is not None:
        reqs = lambda: make_requests(serve, 5)
        st = eng.make_serve_state(reqs(), **SERVE_KW)
        moe.DROPS = []
        try:
            out["serve"] = eng.serve(reqs(), state=st).tokens
            out["serve_hit"] = eng.serve(reqs(), state=st).tokens
            out["serve_drops"] = int(sum(d.sum() for d in moe.DROPS))
            out["serve_moe_calls"] = len(moe.DROPS)
        finally:
            moe.DROPS = None
        out["cache_hits"] = eng.stats["cache_hits"]
        out["pool_blocks"] = (st.pool.local_blocks, st.pool.num_blocks)
    return out


def ep_moe_call_case(rank, world, dev, spec):
    """One expert-parallel MoE call on ``dev`` against the meshless call
    on the CPU: smoke olmoe with capacity dispatch at factor 0.5, batch 4,
    this rank's experts (sliced over ``model``) on its rows (split over
    the FSDP axes).  Returns the largest difference over the output's
    largest magnitude, whether this rank's rows drop the meshless run's
    pairs, how many they drop, and the ``ep`` bytes."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.models import moe
    from repro_torch.sharding import comm, specs
    mesh = mesh_from_spec(spec, dev)
    ax = comm.axis(mesh, "model")
    fax = comm.axis(mesh, specs.fsdp_axes(mesh) or ())
    base = get_config("olmoe-1b-7b").smoke()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, dispatch="capacity", capacity_factor=0.5))
    gen = torch.Generator().manual_seed(0)
    cpu = moe.MoE(cfg, "cpu")
    cpu.init(lambda p, std: p.copy_(torch.randn(p.shape, generator=gen)
                                    * std))
    x = torch.randn((4, 24, cfg.d_model), generator=gen)
    card = moe.MoE(cfg, dev)
    card.load_state_dict(cpu.state_dict())
    n = cfg.moe.n_experts // ax.size
    with torch.no_grad():
        for t in (card.gate, card.up, card.down):
            t.data = t.data.narrow(0, ax.rank * n, n).clone()
    card.place(ax)
    b = x.shape[0] // fax.size
    rows = slice(fax.rank * b, (fax.rank + 1) * b)
    moe.DROPS = []
    try:
        want = moe.moe_apply(cpu, x, cfg)
        want_drop = moe.DROPS[0].reshape(4, -1, cfg.moe.top_k)[rows]
        comm.reset_counts()
        got = moe.moe_apply(card, x[rows].to(dev), cfg,
                            rows=fax if fax.size > 1 else None).cpu()
        got_drop = moe.DROPS[1].reshape(b, -1, cfg.moe.top_k)
    finally:
        moe.DROPS = None
    rel = float((got - want[rows]).abs().max() / want.abs().max())
    return {"rel": rel, "drops_equal": bool(torch.equal(got_drop,
                                                        want_drop)),
            "drops": int(want_drop.sum()), "experts": card.gate.shape[0],
            "ep_bytes": comm.bytes_by_kind("ep")}


def mamba_call_case(rank, world, dev, spec="model=2"):
    """One zamba2 Mamba2 mixer call on ``dev`` against the meshless call
    on the CPU: smoke zamba2, batch 2, 24 tokens (a sub-chunk and a
    padded tail) from a nonzero state; this rank's SSD heads (its slice of
    every head-aligned leaf over ``model``, ``bc_proj`` and ``conv_bc_*``
    whole, ``out_proj``'s rows) on a state of its heads: its x channels
    and the whole B / C ones in the convolution tail.  Returns the largest
    differences over the largest magnitudes of the output (summed over
    ``model``), the new SSD state of this rank's heads and the new tail,
    and the default scope's bytes (the gated norm's and ``out_proj``'s
    fp32 sums)."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.models import mamba2
    from repro_torch.serving.cache import MambaCache
    from repro_torch.sharding import comm
    mesh = mesh_from_spec(spec, dev)
    ax = comm.axis(mesh, "model")
    cfg = get_config("zamba2-7b").smoke()
    s = cfg.ssm
    di, nh, ch = mamba2._dims(cfg)
    gen = torch.Generator().manual_seed(0)
    cpu = mamba2.Mamba2(cfg, "cpu")
    cpu.init(lambda p, std: p.copy_(torch.randn(p.shape, generator=gen)
                                    * std),
             lambda p, lo, hi: p.copy_(torch.rand(p.shape, generator=gen)
                                       * (hi - lo) + lo))
    x = torch.randn((2, 24, cfg.d_model), generator=gen)
    conv = torch.randn((2, s.d_conv - 1, ch), generator=gen)
    ssd = torch.randn((2, nh, s.head_dim, s.d_state), generator=gen) * 0.1
    with torch.no_grad():
        want, wnew = mamba2.mamba_apply(cpu, x, MambaCache(conv, ssd), cfg)
    card = mamba2.Mamba2(cfg, dev)
    card.load_state_dict(cpu.state_dict())
    hl, cl = nh // ax.size, di // ax.size
    h0, c0 = ax.rank * hl, ax.rank * cl
    with torch.no_grad():
        for name in ("z_proj", "x_proj", "conv_x_w", "conv_x_b", "norm"):
            t = getattr(card, name)
            t.data = t.data.narrow(-1, c0, cl).clone()
        for name in ("dt_proj", "a_log", "d_skip", "dt_bias"):
            t = getattr(card, name)
            t.data = t.data.narrow(-1, h0, hl).clone()
        card.out_proj.data = card.out_proj.data.narrow(0, c0, cl).clone()
    card.place(ax)
    tail = torch.cat([conv[..., c0:c0 + cl], conv[..., di:]], dim=-1)
    comm.reset_counts()
    with torch.no_grad():
        got, new = mamba2.mamba_apply(
            card, x.to(dev), MambaCache(tail.to(dev),
                                        ssd[:, h0:h0 + hl].to(dev)), cfg)
    wtail = torch.cat([wnew.conv[..., c0:c0 + cl], wnew.conv[..., di:]], -1)

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    return {"rel": rel(got, want), "ssd": rel(new.ssd, wnew.ssd[:, h0:h0
                                                                 + hl]),
            "conv": rel(new.conv, wtail), "heads": card.a_log.shape[0],
            "tail": new.conv.shape[-1], "bytes": comm.bytes_by_kind("")}


def meshless_drops(arch, over, flat, toks, new=GEN_NEW):
    """The meshless port's ``generate`` tokens and its capacity calls'
    dropped-pair masks, for ``ep_case`` to be held to."""
    from repro_torch.models import moe
    from repro_torch.serving.engine import Engine
    from repro_torch.training import checkpoint as ckpt
    eng = Engine(ckpt.from_flat(flat, port_cfg(arch, over), "cpu"),
                 method="quoka", device="cpu")
    eng.generate(eng.pad_prompt(toks), new)
    moe.DROPS = []
    try:
        tokens = eng.generate(eng.pad_prompt(toks), new).tokens
        return tokens, [d.numpy() for d in moe.DROPS]
    finally:
        moe.DROPS = None


def _cache_leaves(model, caches):
    """{reference leaf suffix (``kv/k``, ``latent/ckv``, ``mamba/conv``,
    ``rwkv/wkv``, ``cross/k``, ...): [(layer prefix, the tensor this rank
    holds),
    ...]} of a port model's caches (``specs.kv_cache_shapes``'s names)."""
    out = {}
    names = {"kv": ("k", "v", "pos"), "latent": ("ckv", "krope", "pos"),
             "mamba": ("conv", "ssd"),
             "rwkv": ("shift_tm", "shift_cm", "wkv"), "cross": ("k", "v")}
    for si, (stack, sc) in enumerate(zip(model.stacks, caches)):
        for i, c in enumerate(sc):
            pre = f"stacks/{si}/{i % len(stack.period)}"
            if hasattr(c, "mamba"):
                parts = {"mamba": c.mamba, "kv": c.kv}
            elif hasattr(c, "cross"):
                parts = {"kv": c.kv, "cross": c.cross}
            else:
                parts = {next(g for g, ns in names.items()
                              if hasattr(c, ns[0])): c}
            for group, leaf in parts.items():
                for n in names[group]:
                    out.setdefault(f"{group}/{n}", []).append(
                        (pre, getattr(leaf, n)))
    return out


def cache_bytes(model, caches, b, cap, mesh):
    """{leaf suffix: (bytes this rank's caches hold, the bytes
    ``specs.cache_specs`` places on it: each leaf over the sizes of the
    axes its placement names)}, summed over the layers."""
    from repro_torch.sharding import specs
    place = specs.cache_specs(model.cfg, specs.kv_cache_shapes(
        model.cfg, b, cap), mesh)
    shapes = specs.kv_cache_shapes(model.cfg, b, cap)
    out = {}
    for suffix, leaves in _cache_leaves(model, caches).items():
        held = want = 0
        for pre, t in leaves:
            key = f"{pre}/{suffix}"
            n = math.prod(shapes[key][1:]) * t.element_size()
            for ax in place[key][1:]:
                n //= specs._axes_size(mesh, ax)
            held += t.numel() * t.element_size()
            want += n
        out[suffix] = (held, want)
    return out


def kinds_case(rank, world, dev, spec, arch, over, flat, toks, new=GEN_NEW,
               record=False):
    """The mesh checks of the sliding-window and recurrent block kinds on
    one mesh ``spec``: a QUOKA ``generate`` of the batch ``toks`` (``new``
    new tokens) on the mesh, the scoring routes, the collectives' bytes by
    scope and kind, each cache leaf's held bytes beside its placement's
    (``cache_bytes``), the slots of each KV cache held here and its
    capacity, whether the shards reassemble and the parameter bytes held
    beside the placements'; with ``record``, every selecting layer call's
    inputs (whole: gathered over ``data`` and ``model`` under a scope of
    their own) and plan ids, from rank 0."""
    torch.set_num_threads(1)
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import quoka as qk
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.serving.engine import Engine
    from repro_torch.sharding import comm
    from repro_torch.training.checkpoint import leaf_map
    mesh = mesh_from_spec(spec, dev)
    cfg = port_cfg(arch, over)
    full, shd = _models(cfg, flat, dev, mesh)
    eng = Engine(shd, method="quoka", device=dev, mesh=mesh)
    out = {"reassembled": _reassembled(full, shd, mesh, leaf_map),
           "param_bytes": param_bytes(full, shd, mesh)}
    del full
    caches, records = [], []
    init_cache, build = shd.init_cache, plan_mod.build

    def init(*a, **kw):
        caches.append(init_cache(*a, **kw))
        return caches[-1]

    def rec(method, q, k, key_pos, chunk_start, cfg, budget=None,
            q_valid=None, heads=None, seq=None, sketch=None):
        pln = build(method, q, k, key_pos, chunk_start, cfg, budget=budget,
                    q_valid=q_valid, heads=heads, seq=seq, sketch=sketch)
        if record:
            with comm.scope("record"):
                if heads.heads_sharded:
                    q = comm.all_gather(q, heads.ax, 2)
                idx = pln.idx
                whole = [k, key_pos]
                if seq is not None:
                    whole = [comm.all_gather(x, seq.ax, 1) for x in whole]
                if heads.kv_sharded:
                    whole[0] = comm.all_gather(whole[0], heads.ax, 2)
                    if idx.ndim == 3:
                        idx = comm.all_gather(idx, heads.ax, 1)
            if rank == 0:
                records.append(dict(
                    q=q.numpy(), k=whole[0].numpy(),
                    key_pos=whole[1].numpy(), chunk_start=int(chunk_start),
                    budget=budget,
                    q_valid=None if q_valid is None else q_valid.numpy(),
                    idx=idx.numpy()))
        return pln

    eng.generate(eng.pad_prompt(toks), new)          # warm the signature
    shd.init_cache, plan_mod.build = init, rec
    for key in qk.ROUTES:
        qk.ROUTES[key] = 0
    comm.reset_counts()
    calls = _count_calls(shd)
    try:
        out["generate"] = eng.generate(eng.pad_prompt(toks), new).tokens
    finally:
        plan_mod.build = build
        del shd.init_cache, shd._apply_stacks
    cap = eng.pad_prompt(toks)["tokens"].shape[1] + new
    out.update(
        routes=dict(qk.ROUTES), records=records, stack_calls=calls[0],
        bytes={sc: comm.bytes_by_kind(sc)
               for sc in ("score", "seq", "fsdp", "")},
        slots=[(kv.k.shape[1], kv.capacity)
               for kv in _kv_caches(caches[-1])],
        cache_bytes=cache_bytes(shd, caches[-1], len(toks), cap, mesh))
    return out


def _kv_caches(caches):
    """Every KV cache (``KVCache`` / ``SeqKVCache``, zamba2's shared
    block's and whisper's self-attention's among them) of a model's
    caches, in layer order."""
    for sc in caches:
        for c in sc:
            kv = getattr(c, "kv", None) if hasattr(c, "mamba") or \
                hasattr(c, "cross") else c
            if kv is not None and hasattr(kv, "k"):
                yield kv


def _count_ops():
    """Start counting the calls of the kernel wrappers ``ops.score`` and
    ``ops.attention`` (on the CPU their plain versions run, so the launch
    counters stay 0): returns (the counts, a function that stops)."""
    from repro_torch.kernels import ops
    counts = {"score": 0, "attention": 0}
    inner = {k: getattr(ops, k) for k in counts}

    def counting(name):
        def call(*a, **kw):
            counts[name] += 1
            return inner[name](*a, **kw)
        return call

    for k in counts:
        setattr(ops, k, counting(k))

    def stop():
        for k, f in inner.items():
            setattr(ops, k, f)

    return counts, stop


def modality_case(rank, world, dev, spec, arch, over, flat, batch,
                  new=GEN_NEW, mutant=None):
    """The mesh checks of whisper-small or internvl2-1b on one mesh
    ``spec``: a QUOKA ``generate`` of ``batch`` (tokens, and whisper's
    ``frames`` or the VLM's ``patches``; ``new`` new tokens) on the mesh,
    its first-step logits, the scoring routes, the collectives' bytes by
    scope and kind, the layer-stack passes, each cache leaf's held bytes
    beside its placement's (``cache_bytes``, the cross-attention's
    ``cross/{k,v}`` among them), the frames each ``CrossKV`` holds,
    whether the shards reassemble and the parameter bytes held beside the
    placements'.  ``mutant`` ("heads" or "frames") then runs the same
    prefill once more with the cross keys and values written under a
    wrong mapping (the KV heads reversed, or on every rank the first
    rank's frames) and returns its first-step logits."""
    torch.set_num_threads(1)
    from repro_torch.core import quoka as qk
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.models import blocks
    from repro_torch.serving.engine import Engine
    from repro_torch.sharding import comm
    from repro_torch.training.checkpoint import leaf_map
    mesh = mesh_from_spec(spec, dev)
    cfg = port_cfg(arch, over)
    full, shd = _models(cfg, flat, dev, mesh)
    eng = Engine(shd, method="quoka", device=dev, mesh=mesh)
    out = {"reassembled": _reassembled(full, shd, mesh, leaf_map),
           "param_bytes": param_bytes(full, shd, mesh)}
    del full
    caches, firsts = [], []
    init_cache, prefill = shd.init_cache, shd.prefill
    b = len(batch["tokens"])

    def init(*a, **kw):
        caches.append(init_cache(*a, **kw))
        return caches[-1]

    def pre(*a, **kw):
        r = prefill(*a, **kw)
        firsts.append(r[0][:b].float().cpu().numpy())
        return r

    eng.generate(batch, new)                     # warm the signature
    shd.init_cache, shd.prefill = init, pre
    for key in qk.ROUTES:
        qk.ROUTES[key] = 0
    comm.reset_counts()
    calls = _count_calls(shd)
    try:
        out["generate"] = eng.generate(batch, new).tokens
    finally:
        del shd._apply_stacks
    cap = caches[-1][0][0].kv.capacity if hasattr(caches[-1][0][0], "kv") \
        else caches[-1][0][0].capacity
    out.update(
        routes=dict(qk.ROUTES), stack_calls=calls[0], logits=firsts[-1],
        bytes={sc: comm.bytes_by_kind(sc)
               for sc in ("score", "seq", "fsdp", "cross", "")},
        slots=[(kv.k.shape[1], kv.capacity)
               for kv in _kv_caches(caches[-1])],
        frames=[c.cross.k.shape[1] for st in caches[-1] for c in st
                if hasattr(c, "cross")],
        cache_bytes=cache_bytes(shd, caches[-1], b, cap, mesh))
    if mutant is not None:
        write = blocks.DecCrossBlock.write_cross

        def wrong(self, cross, enc_out):
            write(self, cross, enc_out)
            if mutant == "heads":
                cross.k.copy_(cross.k.flip(2).clone())
                cross.v.copy_(cross.v.flip(2).clone())
            else:               # every rank writes the first frames
                write(self, cross._replace(seq=cross.seq._replace(lo=0)),
                      enc_out)

        blocks.DecCrossBlock.write_cross = wrong
        try:
            eng.generate(batch, 1)
        finally:
            blocks.DecCrossBlock.write_cross = write
        out["mutant_logits"] = firsts[-1]
    del shd.init_cache, shd.prefill
    return out


def _snapshot(reg):
    """A registry's values as plain dicts (they cross the process
    boundary): counters and gauges by name, each histogram's count and
    summary."""
    return {"counters": {k: c.value for k, c in reg.counters.items()},
            "gauges": {k: g.value for k, g in reg.gauges.items()},
            "hists": {k: (h.count, h.summary())
                      for k, h in reg.histograms.items()}}


def snapshot_diff(got, want, tol=1e-6):
    """Where two registry ``_snapshot``s differ, as the port's telemetry
    tests compare registries: counters equal, the same gauges within
    ``tol`` (NaN where NaN), the same histograms with equal counts and,
    for those that are not times, summaries within ``tol``.  Returns the
    differences (empty: the same)."""
    import re
    times = re.compile(r"(_s$|^engine/|^sched/(suspend|resume)$|"
                       r"^pool/h2d_stage$)")
    bad = []
    if got["counters"] != want["counters"]:
        bad.append(("counters", got["counters"], want["counters"]))
    if sorted(got["gauges"]) != sorted(want["gauges"]):
        bad.append(("gauge names", sorted(got["gauges"]),
                    sorted(want["gauges"])))
    for k, w in want["gauges"].items():
        g = got["gauges"].get(k, math.inf)
        if not ((math.isnan(g) and math.isnan(w)) or abs(g - w) <= tol):
            bad.append((k, g, w))
    if sorted(got["hists"]) != sorted(want["hists"]):
        bad.append(("histogram names", sorted(got["hists"]),
                    sorted(want["hists"])))
    for k, (n, summ) in want["hists"].items():
        gn, gs = got["hists"].get(k, (None, {}))
        if gn != n:
            bad.append((k, gn, n))
        elif not times.search(k):
            for q, v in summ.items():
                if abs(gs[q] - v) > tol:
                    bad.append((f"{k}/{q}", gs[q], v))
    return bad


def whisper_call_case(rank, world, dev, spec="model=2"):
    """One smoke whisper-small prefill (its encoder over 64 stub frames,
    the cross keys and values, two ``dec_cross`` layers over four chunks
    with QUOKA) and one decode step on ``dev``, sharded on the mesh
    ``spec``, against the meshless calls on the CPU, fp32, batch 2.
    Returns the largest difference over the largest magnitude of the
    prefill's and the decode step's logits, the query heads and the cross
    cache's KV heads a rank holds, and the default scope's bytes."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.models.model import build_model
    from repro_torch.sharding import comm
    from repro_torch.training import checkpoint as ckpt
    mesh = mesh_from_spec(spec, dev)
    cfg = get_config("whisper-small").smoke()
    cpu = build_model(cfg, "cpu", seed=0)
    card = ckpt.from_flat(ckpt.to_flat(cpu), cfg, dev, mesh=mesh)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(3, cfg.vocab, (2, 64)).astype(np.int32),
             **modality_inputs(cfg, 2)}
    want, wc = cpu.prefill(batch, cpu.init_cache(2, 72), "quoka")
    comm.reset_counts()
    got, gc = card.prefill(batch, card.init_cache(2, 72), "quoka")
    tok = want.argmax(-1)
    wd, _ = cpu.decode_step(tok, 64, wc, "quoka")
    gd, _ = card.decode_step(tok.to(dev), 64, gc, "quoka")

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    return {"rel": max(rel(got, want), rel(gd, wd)),
            "heads": card.layers()[0].self_attn.n_heads,
            "cross_kv": gc[0][0].cross.k.shape[2],
            "bytes": comm.bytes_by_kind("")}


def registry_case(rank, world, dev, spec, arch, flat, prompts, new=5):
    """``Engine(mesh=, registry=).serve`` on the mesh ``spec`` for
    ``full`` and ``quoka``: a cold then a warm (prefix-hit) serve of
    ``prompts`` over one state, with a registry, and the same with none.
    Returns per method both runs' tokens, the registry's ``_snapshot``,
    ``Engine.stats``, the kernel wrappers' calls and the ``obs`` scope's
    bytes with the registry on and off."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.obs import Registry
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import make_requests
    from repro_torch.sharding import comm
    mesh = mesh_from_spec(spec, dev)
    cfg = port_cfg(arch, {})
    _, shd = _models(cfg, flat, dev, mesh)
    kw = dict(block_size=16, max_decode_batch=4)
    out = {}
    for method in ("full", "quoka"):
        for on in (True, False):
            reg = Registry() if on else None
            eng = Engine(shd, method=method, device=dev, mesh=mesh,
                         registry=reg)
            st = eng.make_serve_state(make_requests(prompts, new), **kw)
            counts, stop = _count_ops()
            comm.reset_counts()
            try:
                res = [eng.serve(make_requests(prompts, new), state=st)
                       for _ in range(2)]
            finally:
                stop()
            out[(method, on)] = dict(
                tokens=[{r: t.tolist() for r, t in x.tokens.items()}
                        for x in res],
                registry=_snapshot(reg) if on else None,
                stats=dict(eng.stats), calls=counts,
                obs_bytes=comm.bytes_by_kind("obs"))
    return out


def dp_world(rank, world, dev, runs):
    """One spawn of ``tests/test_torch_dp.py``, ``test_torch_ep.py``,
    ``test_torch_mesh_kinds.py`` or ``test_torch_mesh_modality.py``: each
    (name, case, args) of ``runs`` (``serve_case``, ``seq_case``,
    ``gen_case``, ``ep_case``, ``kinds_case``, ``mamba_call_case``,
    ``modality_case``, ``registry_case`` or ``whisper_call_case`` by name,
    with these positional
    arguments after the rank's own), in order.  Returns {name: result}."""
    cases = {"serve": serve_case, "seq": seq_case, "gen": gen_case,
             "ep": ep_case, "kinds": kinds_case,
             "mamba_call": mamba_call_case, "modality": modality_case,
             "registry": registry_case, "whisper_call": whisper_call_case}
    out = {}
    for name, case, args, kw in runs:
        out[name] = cases[case](rank, world, dev, *args, **kw)
    return out


def plan_case(rank, world, dev, cases):
    """The T-local route's plan ids on a ``model=world`` axis for each
    (q, k, key_pos, chunk_start, budget, quoka kwargs): a layer whose
    query and KV heads are all replicated (its ``HeadShard``), with the
    scoring collectives' bytes and the route counts."""
    torch.set_num_threads(1)
    from repro_torch.configs.base import QuokaConfig
    from repro_torch.core import plan
    from repro_torch.core import quoka as qk
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import comm
    ax = comm.axis(make_host_mesh(model=world))
    outs = []
    for q, k, key_pos, start, budget, qkw in cases:
        cfg = QuokaConfig(**qkw)
        h, n_kv = q.shape[2], k.shape[2]
        heads = comm.HeadShard(ax, h, n_kv, h, n_kv, "cpu")
        for key in qk.ROUTES:
            qk.ROUTES[key] = 0
        comm.reset_counts()
        pln = plan.build("quoka", *(torch.as_tensor(x) for x in
                                    (q, k, key_pos)), start, cfg,
                         budget=budget, heads=heads)
        outs.append((pln.idx.numpy(), dict(qk.ROUTES),
                     comm.bytes_by_kind("score")))
    return outs


def refusal_case(rank, world, dev, arch):
    """What a real mesh still refuses: on a ``data=2`` mesh (world 4),
    which now serves, a preempting scheduling policy; a method other than
    full / quoka, and the host tier on a mesh.  Returns the messages."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.pool import PagedKVCache
    cfg = port_cfg(arch, {})
    msgs = {}

    def grab(name, fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            msgs[name] = (type(e).__name__, str(e))

    from repro_torch.serving.request import make_requests
    dp = make_host_mesh(model=2, data=2)
    dpe = Engine(build_model(cfg, dev), device=dev, mesh=dp)
    grab("data2", lambda: dpe.make_serve_state(
        make_requests([np.arange(3, 19, dtype=np.int32)], 2),
        policy="slo", **SERVE_KW))
    mp = make_host_mesh(model=4)
    grab("method", lambda: Engine(build_model(cfg, dev), device=dev,
                                  mesh=mp, method="sparq"))
    eng = Engine(build_model(cfg, dev), device=dev, mesh=mp)
    grab("host_tier", lambda: PagedKVCache(eng.model, 8, 16, mesh=mp,
                                           host_tier_blocks=4))
    grab("unsharded_pool", lambda: PagedKVCache(build_model(cfg, dev), 8,
                                                16, mesh=mp))
    return msgs


def subselect_case(rank, world, dev, q, n_queries, n_kv, q_valid):
    """``quoka.subselect_queries_tp`` on this rank's query heads of q (b,
    t, h, d) (its contiguous ``h / world``), gathering every head's."""
    from repro_torch.core import quoka as qk
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import comm
    ax = comm.axis(make_host_mesh(model=world))
    h = q.shape[2]
    hl = h // world
    heads = comm.HeadShard(ax, h, n_kv, hl, n_kv, "cpu")
    mine = torch.as_tensor(q[:, :, rank * hl:(rank + 1) * hl])
    return qk.subselect_queries_tp(
        mine, n_queries, heads,
        q_valid=None if q_valid is None else torch.as_tensor(q_valid)).numpy()


def world_case(rank, world, dev, arch, over, prompts, flat, plans=None,
               new=GEN_NEW, subsel=(), quoka=None):
    """One spawn's checks: ``serve_case``; with ``plans``, ``plan_case``
    and ``refusal_case``; one ``subselect_case`` per entry of
    ``subsel``."""
    out = [serve_case(rank, world, dev, arch, over, flat, prompts,
                      quoka=quoka, new=new)]
    if plans is not None:
        out += [plan_case(rank, world, dev, plans),
                refusal_case(rank, world, dev, arch)]
    out.append([subselect_case(rank, world, dev, *a) for a in subsel])
    return out


def dying_case(rank, world, dev):
    """Rank 1 exits without a result, as a crashed rank would."""
    import os
    if rank == 1:
        os._exit(3)
    return rank


# ---------------------------------------------------------------------------
# data parallelism on the card (``chip_smoke.py`` phase 34 and
# ``tests/test_torch_cuda.py::test_dp_serving_on_the_card``)
# ---------------------------------------------------------------------------

DP_SPEC = "data=2,model=2"
DP_HIT = 256                    # the serve's shared prefix (2 blocks of 128)


def _launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quoka_score as qs
    from repro_torch.kernels import selected_attention as sa
    return {"quoka_score": qs.LAUNCHES, "flash_attention": fa.LAUNCHES,
            "selected_attention": sa.LAUNCHES,
            "selected_attention_paged": sa.PAGED_LAUNCHES}


def _zero_launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quoka_score as qs
    from repro_torch.kernels import selected_attention as sa
    qs.LAUNCHES = fa.LAUNCHES = sa.LAUNCHES = sa.PAGED_LAUNCHES = 0


def dp_card_run(dev, arch, layers, runs, budget, new, mesh=None,
                smoke=False):
    """``arch`` at its published width (its smoke config with ``smoke``)
    cut in depth to ``layers``, from seed 0, selection
    budget ``budget``, meshless (``mesh`` None) or on one rank of
    ``mesh``: for each (label, dtype, batch, prompt) of ``runs`` one
    ``generate`` of ``new`` tokens with QUOKA (a first call on a geometry
    warms it inside), the counts set to 0 just before it; and an fp32
    ``serve`` of a 512-token request, then one sharing its first
    ``DP_HIT`` tokens, on one warm pool (block 128, two decode rows).
    Returns per run: tokens, first-step logits, kernel launches, layer
    stack passes, scoring routes, collective bytes by scope, peak GiB,
    the slots and K bytes each layer's cache holds here, the whole K
    cache's bytes, a budget's row bytes (sequence-sharded caches), the
    parameter bytes held, TTFT; and the serve's tokens, hit and kernel
    launches (the counts set to 0 just before it)."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.core import quoka as qk
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import make_requests
    from repro_torch.sharding import comm
    base = get_config(arch)
    base = dc.replace(base.smoke() if smoke else base, n_layers=layers)
    base = dc.replace(base, quoka=dc.replace(base.quoka, budget=budget))
    cuda = dev.type == "cuda"
    out, model, eng = {}, None, None
    for label, dt, b, prompt in runs:
        cfg = dc.replace(base, dtype=getattr(torch, dt))
        if model is None or model.cfg.dtype != cfg.dtype:
            model = eng = None          # the previous model freed first
            if cuda:
                torch.cuda.empty_cache()
            model = build_model(cfg, dev, seed=0)
        eng = Engine(model, method="quoka", device=dev, mesh=mesh)
        toks = np.random.default_rng(b).integers(
            3, cfg.vocab, (b, prompt)).astype(np.int32)
        caches, firsts = [], []
        calls = _count_calls(model)
        init_cache, prefill = model.init_cache, model.prefill

        def init(*a, **kw):
            caches.append(init_cache(*a, **kw))
            return caches[-1]

        def pre(*a, **kw):
            r = prefill(*a, **kw)
            firsts.append(r[0][:b].float().cpu().numpy())
            return r

        model.init_cache, model.prefill = init, pre
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        comm.reset_counts()
        for key in qk.ROUTES:
            qk.ROUTES[key] = 0
        try:
            r = eng.generate({"tokens": toks}, new)
        finally:
            del model.init_cache, model.prefill, model._apply_stacks
        kv = caches[-1][0][0]
        out[label] = dict(
            tokens=r.tokens.tolist(), logits=firsts[-1], ttft_s=r.ttft_s,
            launches=_launches(), stack_calls=calls[0],
            routes=dict(qk.ROUTES),
            bytes={s or "other": comm.bytes_by_kind(s)
                   for s in ("fsdp", "seq", "score", "")},
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30
            if cuda else None,
            slots=kv.k.shape[1], cap=kv.capacity,
            k_slice_bytes=kv.k.numel() * kv.k.element_size(),
            k_bytes=kv.capacity * b * cfg.n_kv_heads * cfg.resolved_head_dim
            * kv.k.element_size(),
            budget_bytes=_budget_bytes(kv, cfg.quoka)
            if kv.seq is not None else None,
            param_bytes=sum(p.numel() * p.element_size()
                            for p in model.parameters()))
    cfg = dc.replace(base, dtype=torch.float32)
    if model is None or model.cfg.dtype != torch.float32:
        model = eng = None
        if cuda:
            torch.cuda.empty_cache()
        model = build_model(cfg, dev, seed=0)
    model.cfg = dc.replace(cfg, quoka=dc.replace(cfg.quoka, granularity=16))
    rng = np.random.default_rng(5)
    a = rng.integers(3, cfg.vocab, (512,)).astype(np.int32)
    c = np.concatenate([a[:DP_HIT], rng.integers(3, cfg.vocab, (128,))
                        .astype(np.int32)])
    eng = Engine(model, method="quoka", device=dev, mesh=mesh)
    st = eng.make_serve_state(make_requests([a, c], 4), block_size=128,
                              max_decode_batch=2)
    _zero_launches()
    s1 = eng.serve(make_requests([a], 4), state=st)
    s2 = eng.serve(make_requests([c], 4), state=st)
    out["fp32 serve"] = dict(
        tokens=[s1.tokens[0].tolist(), s2.tokens[0].tolist()],
        hit_tokens=float(eng.stats["hit_tokens"]),
        pool_blocks=(st.pool.local_blocks, st.pool.num_blocks),
        launches=_launches())
    return out


def dp_moves(run):
    """A sequence-sharded run's (scoring bytes, budget-row bytes) per
    selecting layer call, from ``dp_card_run``'s record."""
    calls = run["routes"]["seq"] + run["routes"]["seq_t_local"]
    return tuple(sum(run["bytes"][sc].values()) / calls
                 for sc in ("score", "seq"))


def dp_card_case(rank, world, dev, arch, layers, runs, budget, new,
                 smoke=False):
    """One rank of ``dp_card_run`` on the ``DP_SPEC`` mesh, ranks sharing
    the card over gloo (or the CPU)."""
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.sharding import comm
    mesh = mesh_from_spec(DP_SPEC, dev)
    out = dp_card_run(dev, arch, layers, runs, budget, new, mesh=mesh,
                      smoke=smoke)
    out["backend"] = comm.axis(mesh).backend
    if dev.type == "cuda":
        out["peak_all_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


# ---------------------------------------------------------------------------
# expert-parallel MoE and MLA on the card (``chip_smoke.py`` phase 35)
# ---------------------------------------------------------------------------

EP_HIT = 256                    # the latent-pool serve's shared prefix


def _captured(calls, kind):
    """The first recorded ``ops.score`` / ``ops.attention`` call of a run
    held to its plain version on its own inputs: (shapes, max error,
    tolerance).  The re-launch that compares is not counted: the run's
    counts are read before."""
    from repro_torch.kernels import ops, ref
    a, kw = calls[0]
    if kind == "score":
        qbar, k, valid = a
        got = ops.score(qbar, k, valid)
        want = ref.score_ref(qbar.transpose(1, 2), k.transpose(1, 2), valid)
        tol = 1e-4
        shapes = dict(qbar=tuple(qbar.shape), k=tuple(k.shape))
    else:
        q, k, v, valid = a
        got = ops.attention(q, k, v, valid, **kw)
        want = ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            k_valid=valid, **kw).transpose(1, 2)
        top = float(want.float().abs().max())
        # one bf16 ulp of the output's largest magnitude; fp32 2e-5
        tol = 2.0 ** (math.floor(math.log2(top)) - 7) if \
            want.dtype == torch.bfloat16 and top > 0 else 2e-5
        shapes = dict(q=tuple(q.shape), k=tuple(k.shape), v=tuple(v.shape))
    err = float((got.float() - want.float()).abs().max())
    return dict(shapes=shapes, err=err, tol=tol)


def modality_inputs(cfg, b, seed=0):
    """Seeded stub inputs of a modality family's ``b`` rows: whisper's
    encoder frames (b, n_ctx, d) or a VLM's patches (b, n, d_in), fp32
    (the model casts them); none for the other families."""
    rng = np.random.default_rng(100 + seed)
    if cfg.encoder is not None:
        return {"frames": rng.standard_normal(
            (b, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)}
    if cfg.frontend is not None:
        return {"patches": rng.standard_normal(
            (b, cfg.frontend.n_tokens, cfg.frontend.d_in)).astype(
                np.float32)}
    return {}


def _ep_generate(model, eng, b, prompt, new, cuda):
    """One ``ep_card_run`` run (its docstring), on its own frame so that
    nothing of it holds the model when the next one is drawn."""
    from repro_torch.core import quoka as qk
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.sharding import comm
    toks = np.random.default_rng(b).integers(
        3, model.cfg.vocab, (b, prompt)).astype(np.int32)
    batch = {"tokens": toks, **modality_inputs(model.cfg, b)}
    firsts, caches, calls = [], [], _count_calls(model)
    prefill, init_cache = model.prefill, model.init_cache
    rec = {"score": [], "attention": []}
    kernels = {"score": ops.score, "attention": ops.attention}

    def pre(*a, **kw):
        r = prefill(*a, **kw)
        firsts.append(r[0][:b].float().cpu().numpy())
        return r

    def recording(name, selectable):
        # the run's first call with a selectable key: a call on an empty
        # cache (the first chunk) scores nothing but NEG_INF
        def call(*a, **kw):
            if not rec[name] and bool(selectable(*a, **kw)):
                rec[name].append((a, kw))
            return kernels[name](*a, **kw)
        return call

    def init(*a, **kw):
        caches.append(init_cache(*a, **kw))
        return caches[-1]

    model.prefill, model.init_cache = pre, init
    ops.score = recording("score", lambda qbar, k, valid, **kw: valid.any())
    ops.attention = recording(
        "attention", lambda q, k, v, valid, boundary=0, **kw:
        valid[..., :boundary].any())
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    comm.reset_counts()
    for key in qk.ROUTES:
        qk.ROUTES[key] = 0
    moe.DROPS = []
    try:
        r = eng.generate(batch, new)
        launches = _launches()
        drops = [d.numpy() for d in moe.DROPS]
    finally:
        moe.DROPS = None
        ops.score, ops.attention = kernels["score"], kernels["attention"]
        del model.prefill, model.init_cache, model._apply_stacks
    experts = [blk.moe for blk in model.layers() if hasattr(blk, "moe")]
    held = {leaf: sum(t.numel() * t.element_size() for _, t in ts)
            for leaf, ts in _cache_leaves(model, caches[-1]).items()}
    return dict(
        tokens=r.tokens.tolist(), logits=firsts[-1], ttft_s=r.ttft_s,
        launches=launches, stack_calls=calls[0],
        routes=dict(qk.ROUTES), drops=drops,
        bytes={s or "other": comm.bytes_by_kind(s)
               for s in ("ep", "fsdp", "seq", "score", "cross", "")},
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30
        if cuda else None,
        param_bytes=sum(p.numel() * p.element_size()
                        for p in model.parameters()),
        expert_bytes=sum(t.numel() * t.element_size() for m in experts
                         for t in (m.gate, m.up, m.down)),
        experts_held=experts[0].gate.shape[0] if experts else None,
        cache_bytes=held,
        checked={k: _captured(v, k) for k, v in rec.items() if v})


def ep_card_run(dev, arch, cut, runs, budget, new, mesh=None, serve=False,
                turns=False):
    """``arch`` at its published width cut in depth by the config
    overrides ``cut``, from seed 0, selection budget ``budget``, meshless
    (``mesh`` None) or on one rank of ``mesh`` (with ``turns``, the ranks
    draw their whole models one after another, each sharding before the
    next draws, so two whole copies never share the card): for each
    (label, dtype, batch, prompt, MoE config overrides) of ``runs`` (a
    run of the previous run's dtype reuses its model) one QUOKA
    ``generate`` of
    ``new`` tokens (its first call on a geometry warms it inside, and the
    counts, set to 0 just before it, include that).  Returns per run: tokens, first-step logits,
    kernel launches, layer-stack passes, scoring routes, collective bytes
    by scope, each MoE call's dropped-pair mask of this rank's rows, peak
    GiB, held parameter and expert bytes, and the first scoring and flash
    calls held to their plain versions on their own inputs, and each cache
    leaf's bytes held here (``_cache_leaves``' names); with
    ``serve`` a 512-token request and then one sharing its first
    ``EP_HIT`` tokens over one pool (block 128, two decode rows): their
    tokens, the hit and the launches."""
    import dataclasses as dc

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import make_requests
    from repro_torch.sharding import comm, specs
    base = dc.replace(get_config(arch), **cut)
    base = dc.replace(base, quoka=dc.replace(base.quoka, budget=budget))
    cuda = dev.type == "cuda"
    if mesh is not None:        # every group made before any rank draws
        comm.axis(mesh, "model")
        comm.axis(mesh, specs.fsdp_axes(mesh) or ())
        comm.world(mesh)
    out, model, eng = {}, None, None
    for label, dt, b, prompt, moe_over in runs:
        cfg = dc.replace(base, dtype=getattr(torch, dt))
        if moe_over:
            cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, **moe_over))
        if model is not None and model.cfg.dtype == cfg.dtype:
            model.cfg = cfg             # the next run's MoE settings
            for blk in model.layers():
                blk.cfg = cfg
        else:
            model = eng = None
            if cuda:
                torch.cuda.empty_cache()
            order = range(dist.get_world_size()) if turns else [None]
            for turn in order:
                if turn is None or turn == dist.get_rank():
                    model = build_model(cfg, dev, seed=0)
                    eng = Engine(model, method="quoka", device=dev,
                                 mesh=mesh)
                    if cuda:
                        torch.cuda.synchronize()
                        torch.cuda.empty_cache()
                if turn is not None:
                    dist.barrier()
        out[label] = _ep_generate(model, eng, b, prompt, new, cuda)
    if serve:                   # at the config's own MoE settings
        model.cfg = dc.replace(base, dtype=model.cfg.dtype)
        for blk in model.layers():
            blk.cfg = model.cfg
        rng = np.random.default_rng(5)
        a = rng.integers(3, model.cfg.vocab, (512,)).astype(np.int32)
        c = np.concatenate([a[:EP_HIT], rng.integers(
            3, model.cfg.vocab, (128,)).astype(np.int32)])
        st = eng.make_serve_state(make_requests([a, c], 4), block_size=128,
                                  max_decode_batch=2)
        _zero_launches()
        s1 = eng.serve(make_requests([a], 4), state=st)
        s2 = eng.serve(make_requests([c], 4), state=st)
        out["serve"] = dict(
            tokens=[s1.tokens[0].tolist(), s2.tokens[0].tolist()],
            hit_tokens=float(eng.stats["hit_tokens"]),
            pool_blocks=(st.pool.local_blocks, st.pool.num_blocks),
            launches=_launches())
    return out


def kinds_card_case(rank, world, dev, spec, cases, budget):
    """One rank of ``chip_smoke.py`` phase 36 or 37 on the mesh ``spec``:
    for
    each (label, arch, config cut, runs, new, turns) of ``cases``
    ``ep_card_run`` (its runs are (label, dtype, batch, prompt, {})), on
    one mesh, the card freed between cases."""
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.sharding import comm
    mesh = mesh_from_spec(spec, dev)
    out = {"backend": comm.axis(mesh).backend}
    for label, arch, cut, runs, new, turns in cases:
        out[label] = ep_card_run(dev, arch, cut, runs, budget, new,
                                 mesh=mesh, turns=turns)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def ep_card_case(rank, world, dev, spec, arch, cut, runs, budget, new,
                 serve=False, turns=False):
    """One rank of ``ep_card_run`` on the mesh ``spec``, ranks sharing the
    card over gloo (or the CPU)."""
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.sharding import comm
    mesh = mesh_from_spec(spec, dev)
    out = ep_card_run(dev, arch, cut, runs, budget, new, mesh=mesh,
                      serve=serve, turns=turns)
    out["backend"] = comm.axis(mesh).backend
    if dev.type == "cuda":
        out["peak_all_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out
