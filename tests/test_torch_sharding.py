"""Tensor-parallel serving of the port on a ``model`` mesh axis, against
the reference (CPU, fp32).

  * ``sharding/specs.py``: ``param_specs`` equals the reference's, leaf for
    leaf, for all 12 configs at full width on four meshes (the reference
    tests' ``FakeMesh``), granite's "KV not split through" included;
    ``cache_specs`` equals it on every smoke config's caches (linear,
    paged, and batch 1 with the sequence over ``data``);
  * ``launch/mesh.py``: the reference's errors;
  * gloo ranks under ``torch.multiprocessing`` (``launch/mesh.py::
    spawn_ranks``, a ``file://`` rendezvous), one spawn per world size,
    several checks each: the T-local plan at ``model=4`` (granularity 1
    and 16, sinks, forced ties, invalid slots) equals the reference's
    meshless ``plan.build`` id for id, its collectives move under a
    quarter of the K cache's bytes; smoke granite at ``model=2`` (every
    axis shards) and ``model=4`` (KV heads replicated, the T-local route)
    and a llama smoke model at ``model=3`` whose GQA groups straddle the
    ranks give ``generate`` / ``serve`` / warm-pool prefix-hit tokens
    equal to the port's meshless run and to the reference's meshless
    ``Engine``; shards reassemble to the full leaves; what is not ported
    raises with its message.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.configs import get_config as ref_config
from repro.core import plan as ref_plan
from repro.configs.base import QuokaConfig as RefQuokaConfig
from repro.launch import mesh as ref_mesh
from repro.models.model import build_model as ref_build
from repro.serving.engine import Engine as RefEngine
from repro.serving.request import make_requests as ref_requests
from repro.sharding import specs as ref_specs
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config
from repro_torch.launch import mesh as lm
from repro_torch.models.model import Model
from repro_torch.sharding import specs
from repro_torch.training import checkpoint as ckpt

import torch_tp_cases as cases

torch.set_num_threads(2)


class FakeMesh:
    """Just enough mesh surface for placement (no devices needed)."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = [{"data": 16, "model": 16}, {"model": 4}, {"model": 3},
          {"data": 2, "model": 4}]
# the cache rules name the data axis (the reference's raise without one)
CACHE_MESHES = [{"data": 16, "model": 16}, {"data": 1, "model": 4},
                {"data": 1, "model": 3}, {"data": 2, "model": 4}]


def _ref_flat_specs(tree, spec_tree):
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]
    return {ref_specs._path_str(p): tuple(s) for p, s in flat}


@pytest.mark.parametrize("arch", list(ASSIGNED))
def test_param_specs_equal_reference(arch):
    """Every leaf's placement equals the reference's, on shapes alone (a
    meta-device port model; the reference's ``eval_shape``)."""
    rcfg = ref_config(arch)
    rmodel = ref_build(rcfg)
    params = jax.eval_shape(rmodel.init, jax.random.PRNGKey(0))
    pm = Model(get_config(arch), device="meta")
    for shape in MESHES:
        mesh = FakeMesh(shape)
        want = _ref_flat_specs(params, ref_specs.param_specs(rcfg, params,
                                                             mesh))
        got = specs.param_specs(pm.cfg, pm, mesh)
        assert got == want, (arch, shape)
        if arch == "granite-3-2b" and shape == MESHES[0]:
            # kv=8 on a 16-way model axis: wk/wv are not split through
            assert all("model" not in s for k, s in got.items()
                       if re.search(r"/w[kv]/w$", k))
            assert all("model" in s for k, s in got.items()
                       if k.endswith("/wq/w"))


@pytest.mark.parametrize("layout", ["linear", "paged", "seq"])
def test_cache_specs_equal_reference(layout):
    """Every smoke config's cache leaves, placed as the reference places
    them: a (2, 64) cache, a pool of 8 blocks of 16 (``paged=True``), and
    a batch-1 cache of 4096 whose sequence shards over ``data``."""
    b, cap = {"linear": (2, 64), "paged": (8, 16), "seq": (1, 4096)}[layout]
    for arch in ASSIGNED:
        rcfg = ref_config(arch).smoke()
        rmodel = ref_build(rcfg)
        cache = jax.eval_shape(lambda: rmodel.init_cache(b, cap))
        flat = jax.tree_util.tree_flatten_with_path(cache)[0]
        shapes = {ref_specs._path_str(p): tuple(x.shape) for p, x in flat}
        for shape in CACHE_MESHES:
            mesh = FakeMesh(shape)
            want = _ref_flat_specs(cache, ref_specs.cache_specs(
                rcfg, cache, mesh, paged=layout == "paged"))
            got = specs.cache_specs(get_config(arch).smoke(), shapes, mesh,
                                    paged=layout == "paged")
            assert got == want, (arch, layout, shape)
            if layout == "seq" and shape["data"] > 1:
                assert all(s[2] == "data" for k, s in got.items()
                           if k.endswith("/kv/k")), arch
    # the attention model's leaves the pool reads are the reference's
    cfg = get_config("qwen3-4b").smoke()
    rmodel = ref_build(ref_config("qwen3-4b").smoke())
    cache = jax.eval_shape(lambda: rmodel.init_cache(8, 16))
    want = {ref_specs._path_str(p): tuple(x.shape) for p, x in
            jax.tree_util.tree_flatten_with_path(cache)[0]
            if "/kv/" in ref_specs._path_str(p)}
    assert specs.kv_cache_shapes(cfg, 8, 16) == want


def test_mesh_spec_errors_match_reference():
    for bad in ("data=2,model=x", "rows=2", "data2"):
        with pytest.raises(ValueError) as want:
            ref_mesh.parse_mesh_spec(bad)
        with pytest.raises(ValueError) as got:
            lm.parse_mesh_spec(bad)
        assert str(got.value) == str(want.value)
    assert lm.parse_mesh_spec("data=2,model=4") == \
        ref_mesh.parse_mesh_spec("data=2,model=4")
    n = len(jax.devices())
    head = f"mesh 'data=2,model=4' needs 8 devices but {n} are visible"
    with pytest.raises(ValueError, match=re.escape(head)):
        ref_mesh.mesh_from_spec("data=2,model=4")
    with pytest.raises(ValueError, match=re.escape(head)):
        lm.mesh_from_spec("data=2,model=4", device="cpu")
    with pytest.raises(ValueError, match="needs 256 devices"):
        lm.make_production_mesh(device="cpu")


def test_refusals_without_ranks():
    """What the checks admit before any rank meets: a dense ``attn``
    model, the sliding-window and recurrent kinds and the modality
    families place on a data axis; a ring's, a Mamba2 state's and
    whisper's cross-attention cache placements are the reference's
    ``cache_specs`` on the reference's leaves; the MLA latent pool's
    placement puts its blocks over the FSDP axes, never over ``model``;
    and a block kind no mesh places still raises."""
    from repro_torch.models.model import build_model
    pm = build_model(get_config("granite-3-2b").smoke(), "cpu")
    ckpt.check_mesh(pm.cfg, FakeMesh({"data": 2, "model": 1}))
    for arch in ("zamba2-7b", "gemma3-27b", "h2o-danube-3-4b",
                 "rwkv6-1.6b", "whisper-small", "internvl2-1b"):
        ckpt.check_mesh(get_config(arch), FakeMesh({"data": 2, "model": 2}))
    for arch, leaves in (("gemma3-27b", ("kv/k", "kv/pos")),
                         ("zamba2-7b", ("mamba/conv", "mamba/ssd",
                                        "kv/k")),
                         ("whisper-small", ("cross/k", "cross/v", "kv/k")),
                         ("internvl2-1b", ("kv/k", "kv/pos"))):
        rcfg = ref_config(arch).smoke()
        rmodel = ref_build(rcfg)
        for b in (2, 1):
            cache = jax.eval_shape(lambda: rmodel.init_cache(b, 128))
            mesh = FakeMesh({"data": 2, "model": 2})
            want = _ref_flat_specs(cache, ref_specs.cache_specs(rcfg, cache,
                                                                mesh))
            got = specs.cache_specs(get_config(arch).smoke(),
                                    specs.kv_cache_shapes(
                                        get_config(arch).smoke(), b, 128),
                                    mesh)
            assert set(got) == set(want) - {"enc_done"}
            for key, spec in got.items():
                assert spec == want[key], (arch, key)
            assert any(k.endswith(leaves) for k in got)
            if arch == "gemma3-27b":        # the ring: 64 slots, over data
                ring = got["stacks/0/0/kv/k"]
                assert ring[2] == ("data" if b == 1 else None)
    ds = get_config("deepseek-v3-671b").smoke()
    for mesh in ({"data": 2, "model": 2}, {"pod": 2, "data": 2}):
        place = specs.cache_specs(ds, specs.kv_cache_shapes(ds, 8, 16),
                                  FakeMesh(mesh), paged=True)
        fsdp = specs.fsdp_axes(FakeMesh(mesh))
        assert set(place) == {f"stacks/0/{j}/latent/{leaf}" for j in (0, 1)
                              for leaf in ("ckv", "krope", "pos")}
        for key, spec in place.items():
            assert spec[1] == fsdp and "model" not in spec, (key, spec)
            assert spec[2] is None, (key, spec)      # slots never split
    for arch in ("whisper-small", "internvl2-1b"):
        m = Model(get_config(arch).smoke(), device="meta")
        assert ckpt.check_mesh(m.cfg, FakeMesh({"model": 2})) is None
    odd = dataclasses.replace(get_config("granite-3-2b").smoke(),
                              layer_pattern=("attn", "xattn"))
    with pytest.raises(NotImplementedError) as err:
        ckpt.check_mesh(odd, FakeMesh({"model": 2}))
    assert "block kinds ['xattn'] are not placed on a mesh " \
        "('attn', 'attn_local', 'attn_moe', 'mla', 'mla_moe', 'mamba', " \
        "'mamba_shared_attn', 'rwkv', 'dec_cross', 'enc_attn' only)" \
        in str(err.value)


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------

GRANITE = ("granite-3-2b", {})
# a group of 3 over 6 heads on model=3: rank 1's heads 2, 3 read KV heads
# 0, 1 (the groups straddle); a vocab of 513 shards three ways, d_ff 512
# does not (the MLP stays replicated)
STRADDLE = ("llama3-2-3b", {"n_heads": 6, "n_kv_heads": 2, "vocab": 513})


def _ref_run(arch, over, prompts, new=cases.GEN_NEW, quoka=None):
    """The reference's meshless tokens and flat weights of a smoke
    config: generate (``new`` tokens), then serve, for full and quoka."""
    rcfg = ref_config(arch).smoke(**over)
    if quoka:
        rcfg = dataclasses.replace(rcfg, quoka=dataclasses.replace(
            rcfg.quoka, **quoka))
    rm = ref_build(rcfg)
    params = rm.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    toks = np.stack([prompts[1], prompts[1][::-1].copy()])
    want = {}
    for method in ("full", "quoka"):
        eng = RefEngine(rm, params, method=method)
        want[f"{method}/generate"] = np.asarray(eng.generate(
            eng.pad_prompt(toks), new).tokens)
        want[f"{method}/serve"] = eng.serve(ref_requests(prompts, 5),
                                            **cases.SERVE_KW).tokens
    return flat, want


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(3, vocab, (n,)).astype(np.int32)
            for n in (16, 48, 29)]


@pytest.fixture(scope="module")
def granite_ref():
    prompts = _prompts(get_config("granite-3-2b").smoke().vocab)
    return prompts, *_ref_run(*GRANITE, prompts)


def _plan_cases():
    """(inputs, reference plan ids) at granularity 1 and 16: sinks, keys
    duplicated in each rank's slice and across slices (forced ties),
    invalid slots (pos -1 and past the chunk start)."""
    rng = np.random.default_rng(21)
    b, t, h, n_kv, T, d = 2, 16, 4, 2, 128, 16
    out, want = [], []
    for g in (1, 16):
        q = rng.standard_normal((b, t, h, d)).astype(np.float32)
        k = rng.standard_normal((b, T, n_kv, d)).astype(np.float32)
        k[:, 40:48] = k[:, 8:16]           # ties within rank 1's slice
        k[:, 96:104] = k[:, 8:16]          # and across ranks 0 and 3
        key_pos = np.arange(T, dtype=np.int32)[None].repeat(b, 0)
        key_pos[1, 110:] = -1
        start = 100
        qkw = dict(granularity=g, budget=48, n_queries=4, keep_first=4)
        got = ref_plan.build("quoka", jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(key_pos), jnp.int32(start),
                             RefQuokaConfig(**qkw))
        out.append((q, k, key_pos, start, None, qkw))
        want.append(np.asarray(got.idx))
    # the reference test's geometry for the bytes: granite smoke, T = 64
    rq = ref_config("granite-3-2b").smoke().quoka
    q = rng.standard_normal((2, 16, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 64)).astype(np.float32)
    pos = np.arange(64, dtype=np.int32)[None].repeat(2, 0)
    qkw = {f: getattr(rq, f) for f in ("granularity", "budget", "n_queries",
                                       "keep_first")}
    out.append((q, k, pos, 48, None, qkw))
    want.append(np.asarray(ref_plan.build(
        "quoka", jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
        jnp.int32(48), RefQuokaConfig(**qkw)).idx))
    return out, want


@pytest.fixture(scope="module")
def world4(granite_ref):
    prompts, flat, _ = granite_ref
    plans, want = _plan_cases()
    serve, plan, refuse, _ = lm.spawn_ranks(
        cases.world_case, 4, *GRANITE, prompts, flat, plans,
        timeout=250)[0]
    return serve, plan, refuse, want


def test_tp_plan_candidates_equal_reference_plan(world4):
    _, plan, _, want = world4
    for (ids, routes, nbytes), w in zip(plan, want):
        assert routes == {"t_local": 1, "replicated": 0, "kv_heads": 0,
                          "seq": 0, "seq_t_local": 0}
        np.testing.assert_array_equal(ids, w)


def test_scoring_moves_candidates_not_the_k_cache(world4):
    """Under a quarter of the K cache's bytes, on the reference test's
    geometry and per selecting layer call of the sharded ``generate``
    (sub-selected queries gathered, since granite's heads shard)."""
    serve, plan, _, _ = world4
    nbytes = sum(plan[-1][2].values())
    k_bytes = 2 * 64 * 2 * 64 * 4
    assert set(plan[-1][2]) == {"all_gather"}
    assert 0 < nbytes < k_bytes / 4, (nbytes, k_bytes)
    calls = sum(serve["quoka/routes"].values())
    per_call = sum(serve["quoka/score_bytes"].values()) / calls
    assert serve["quoka/routes"]["t_local"] == calls > 0
    assert per_call < serve["k_bytes"] / 4, (per_call, serve["k_bytes"])


def _check_tokens(res, want, prompts):
    for method in ("full", "quoka"):
        np.testing.assert_array_equal(res[f"{method}/generate_mesh"],
                                      res[f"{method}/generate"])
        np.testing.assert_array_equal(res[f"{method}/generate_mesh"],
                                      want[f"{method}/generate"])
        for i in range(len(prompts)):
            for key in ("serve", "serve_mesh", "serve_hit"):
                np.testing.assert_array_equal(res[f"{method}/{key}"][i],
                                              want[f"{method}/serve"][i])
        assert res[f"{method}/cache_hits"] > 0
    assert res["reassembled"]


@pytest.mark.parametrize("method", ["full", "quoka"])
def test_model4_tokens_equal_meshless_and_reference(world4, granite_ref,
                                                    method):
    serve = world4[0]
    _check_tokens(serve, granite_ref[2], granite_ref[0])
    assert serve["backend"] == "gloo"


def test_mesh_refusals_on_ranks(world4):
    msgs = world4[2]
    # a data axis serves (the engine was built); a preempting policy on
    # it is what is refused
    assert msgs["data2"][0] == "NotImplementedError"
    assert "not yet ported" in msgs["data2"][1]
    assert "preempting scheduling policy (slo)" in msgs["data2"][1]
    assert "not yet ported" in msgs["method"][1]
    assert msgs["host_tier"] == (
        "ValueError", "host tier + mesh is not supported yet: demotion "
        "would have to gather a sharded block slab per eviction")
    assert "shard the model" in msgs["unsharded_pool"][1]


def test_model2_every_axis_shards(granite_ref):
    prompts, flat, want = granite_ref
    res = [r[0] for r in lm.spawn_ranks(cases.world_case, 2, *GRANITE,
                                        prompts, flat, timeout=250)]
    for r in res[1:]:            # every rank returns the same tokens
        np.testing.assert_array_equal(r["quoka/generate_mesh"],
                                      res[0]["quoka/generate_mesh"])
    _check_tokens(res[0], want, prompts)
    assert res[0]["quoka/routes"]["kv_heads"] > 0
    assert res[0]["quoka/routes"]["t_local"] == 0


def test_model2_block_plans_take_the_max_across_ranks():
    """Granularity 16 at ``model=2``: each rank scores its own KV heads,
    and the head-shared block plan's max over KV heads is an all-reduce
    max, so every rank builds the reference's meshless plan."""
    g16 = {"granularity": 16}
    prompts = _prompts(get_config("granite-3-2b").smoke().vocab)
    flat, want = _ref_run(*GRANITE, prompts, quoka=g16)
    res = lm.spawn_ranks(cases.world_case, 2, *GRANITE, prompts, flat,
                         None, cases.GEN_NEW, (), g16, timeout=250)[0][0]
    _check_tokens(res, want, prompts)
    assert res["quoka/routes"]["kv_heads"] > 0
    assert res["quoka/score_bytes"].get("all_reduce_max", 0) > 0


def test_model3_straddling_groups():
    """Prompt 48 and 6 new: a cache of 54 splits three ways, so generate
    takes the T-local route on every selecting call.  The sub-selected
    queries every rank gathers (6 heads, groups of 3 over 3 ranks, with
    and without padded rows, and a decode step's one query) equal the
    reference's ``subselect_queries`` on all heads, element for element."""
    from repro.core.quoka import subselect_queries
    prompts = _prompts(STRADDLE[1]["vocab"])
    flat, want = _ref_run(*STRADDLE, prompts, new=6)
    rng = np.random.default_rng(31)
    q = rng.standard_normal((2, 16, 6, 8)).astype(np.float32)
    q_valid = np.ones((2, 16), bool)
    q_valid[1, :5] = False
    subsel = [(q, 4, 2, None), (q, 4, 2, q_valid), (q[:, :1], 4, 2, None)]
    ranks = lm.spawn_ranks(cases.world_case, 3, *STRADDLE, prompts, flat,
                           None, 6, subsel, timeout=250)
    res = ranks[0][0]
    _check_tokens(res, want, prompts)
    routes = res["quoka/routes"]
    assert routes["t_local"] > 0 and routes["replicated"] == 0
    for r in ranks:
        for got, (qq, n, n_kv, qv) in zip(r[-1], subsel):
            ref = subselect_queries(
                jnp.asarray(qq), n, n_kv=n_kv,
                q_valid=None if qv is None else jnp.asarray(qv))
            np.testing.assert_array_equal(got, np.asarray(ref))


def test_spawn_ranks_stops_when_a_rank_dies_without_a_result():
    """A rank that exits without reporting (a crash) fails the spawn
    within seconds, not at the timeout."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"exited without a result: "
                                           r"\{1: 3\}"):
        lm.spawn_ranks(cases.dying_case, 2, timeout=250)
    assert time.monotonic() - t0 < 120
