"""Rank bodies of the port's tensor-parallel checks, run by
``launch/mesh.py::spawn_ranks`` from ``tests/test_torch_sharding.py`` (on
the CPU, gloo) and ``tests/test_torch_cuda.py`` (ranks sharing the card).
This module imports neither ``jax`` nor the reference package: the
reference's weights and expected outputs arrive as numpy arguments."""
import dataclasses

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
               new=GEN_NEW):
    """generate (two prompts, ``new`` new tokens), a serve trace and the same
    trace again over the warm pool, meshless and on a ``model=world``
    mesh, for ``full`` and ``quoka``.  Returns every token array, the
    scoring routes, the scoring collectives' bytes per T-local call
    beside the K cache's bytes per layer call, and whether every sharded
    leaf reassembles to the meshless model's."""
    torch.set_num_threads(1)
    from repro_torch.core import quoka as qk
    from repro_torch.launch.mesh import make_host_mesh, mesh_from_spec
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import make_requests
    from repro_torch.sharding import comm
    from repro_torch.training.checkpoint import leaf_map
    mesh = make_host_mesh(model=world) if dev.type == "cpu" else \
        mesh_from_spec(f"model={world}", dev)
    cfg = port_cfg(arch, over, quoka)
    out = {"backend": comm.axis(mesh).backend}
    toks = np.stack([prompts[1], prompts[1][::-1].copy()])
    for method in ("full", "quoka"):
        full, shd = _models(cfg, flat, dev, mesh)
        ref = Engine(full, method=method, device=dev)
        eng = Engine(shd, method=method, device=dev, mesh=mesh)
        if method == "full":
            out["reassembled"] = _reassembled(full, shd, mesh, leaf_map)
        out[f"{method}/generate"] = ref.generate(ref.pad_prompt(toks),
                                                 new).tokens
        for k in list(qk.ROUTES):
            qk.ROUTES[k] = 0
        comm.reset_counts()
        out[f"{method}/generate_mesh"] = eng.generate(
            eng.pad_prompt(toks), new).tokens
        out[f"{method}/routes"] = dict(qk.ROUTES)
        out[f"{method}/score_bytes"] = comm.bytes_by_kind("score")
        reqs = make_requests(prompts, 5)
        out[f"{method}/serve"] = ref.serve(reqs, **SERVE_KW).tokens
        st = eng.make_serve_state(make_requests(prompts, 5), **SERVE_KW)
        out[f"{method}/serve_mesh"] = eng.serve(make_requests(prompts, 5),
                                                state=st).tokens
        out[f"{method}/serve_hit"] = eng.serve(make_requests(prompts, 5),
                                               state=st).tokens
        out[f"{method}/cache_hits"] = eng.stats["cache_hits"]
    hd = cfg.resolved_head_dim
    cap = toks.shape[1] + new
    out["k_bytes"] = toks.shape[0] * cap * cfg.n_kv_heads * hd * 4
    return out


def _reassembled(full, shd, mesh, leaf_map):
    """Every leaf of the sharded model, gathered over the model axis
    where it was sliced, equals the meshless model's."""
    from repro_torch.sharding import comm
    ax = comm.axis(mesh)
    fl, sl = leaf_map(full), leaf_map(shd)
    for key, (fts, _) in fl.items():
        for ft, st in zip(fts, sl[key][0]):
            if ft.shape != st.shape:
                dim = next(i for i, (a, b) in enumerate(zip(ft.shape,
                                                            st.shape))
                           if a != b)
                st = comm.all_gather(st, ax, dim)
            if not torch.equal(ft, st):
                return False
    return True


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
    """What a real mesh still refuses: a ``data=2`` mesh (world 4),
    ``registry=`` with a mesh, a method other than full / quoka, and the
    host tier on a mesh.  Returns the messages."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.obs import Registry
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.pool import PagedKVCache
    cfg = port_cfg(arch, {})
    msgs = {}

    def grab(name, fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            msgs[name] = (type(e).__name__, str(e))

    dp = make_host_mesh(model=2, data=2)
    grab("data2", lambda: Engine(build_model(cfg, dev), device=dev,
                                 mesh=dp))
    mp = make_host_mesh(model=4)
    grab("registry", lambda: Engine(build_model(cfg, dev), device=dev,
                                    mesh=mp, registry=Registry()))
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
