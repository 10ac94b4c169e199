"""Expert-parallel MoE and MLA serving of the port on the ``model``,
``data`` and ``pod`` mesh axes, against the reference (CPU, fp32, gloo
ranks).

One ``launch/mesh.py::spawn_ranks`` per world size (2, 3 and 4 ranks, side
by side; the rank bodies are ``tests/torch_tp_cases.py::ep_case``), while
the reference's and the port's meshless runs go on in this process, on
the reference's flat weights:

  * olmoe smoke (4 experts, top-2) at ``model=2`` (the experts divide:
    two a rank, the dense dispatch split), ``model=3`` (they do not: every
    rank holds all four and the routed output is not summed over
    ``model``), ``data=2,model=2`` (rows over ``data``) and
    ``pod=2,data=2`` (batch 4, rows over the flattened group): greedy
    tokens equal the port's meshless run and the reference's meshless
    ``Engine``; with capacity factor 0.5 pairs drop, and the dropped
    (token, choice) pairs of the ranks' rows, taken in rank order, equal
    the meshless run's call for call (the capacity ranking is global);
    a serve and its prefix hit on ``data=2,model=2`` at a capacity where
    nothing can drop (factor E / k, asserted);
  * deepseek smoke (MLA + MoE with a shared expert, untied read-out, MTP)
    at ``model=2``: every selecting call takes the T-local route on the
    latent and its plan equals the reference's meshless ``plan.build`` id
    for id; the latent pool serves with a prefix hit; at ``data=2,model=2``
    batch 2 (rows) and batch 1 (the latent's sequence over ``data``: the
    sequence route, T-local inside each slice) and at ``pod=2,data=2``
    batch 1 (the sequence route): tokens equal.  Every sharded leaf
    reassembles to the meshless model's and each rank holds its
    placements' bytes.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import plan as ref_plan
from repro.models.model import build_model as ref_build
from repro.serving.engine import Engine as RefEngine
from repro.serving.request import make_requests as ref_requests
from repro.sharding import specs as ref_specs
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config
from repro_torch.launch import mesh as lm
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import make_requests
from repro_torch.sharding import specs
from repro_torch.training import checkpoint as ckpt

import torch_tp_cases as cases

torch.set_num_threads(2)

MOE, MLA = "olmoe-1b-7b", "deepseek-v3-671b"
POD = "pod=2,data=2,model=1"
LONG = 96                    # batch 1: a 104-slot latent, 52 a data rank


def _moe_over(**kw):
    return {"moe": dataclasses.replace(get_config(MOE).smoke().moe, **kw)}


DENSE = {}                                         # the smoke dispatch
DROP = _moe_over(dispatch="capacity", capacity_factor=0.5)
NODROP = _moe_over(dispatch="capacity", capacity_factor=2.0)   # E / k


def _inputs(vocab):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, vocab, (n,)).astype(np.int32)
               for n in (16, 48, 29)]
    b2 = np.stack([prompts[1], prompts[1][::-1].copy()])
    b4 = np.concatenate([b2, np.roll(b2, 5, axis=1)])
    long = rng.integers(3, vocab, (1, LONG)).astype(np.int32)
    return prompts, b2, b4, long


def _runs(flats, inp):
    """Each world's runs (``torch_tp_cases.dp_world``):
    (name, "ep", (spec, arch, over, flat, toks), kw)."""
    prompts, b2, b4, long = inp
    fm, fd = flats[MOE], flats[MLA]
    return {
        2: [("moe_m2", "ep", ("model=2", MOE, DENSE, fm, b2),
             dict(serve=prompts)),
            ("mla_m2", "ep", ("model=2", MLA, {}, fd, b2),
             dict(serve=prompts, record=True))],
        3: [("moe_m3", "ep", ("model=3", MOE, DROP, fm, b2), {})],
        4: [("moe_dm_drop", "ep", ("data=2,model=2", MOE, DROP, fm, b2), {}),
            ("moe_dm_serve", "ep", ("data=2,model=2", MOE, NODROP, fm, b2),
             dict(serve=prompts)),
            ("moe_pod_b4", "ep", (POD, MOE, DROP, fm, b4), {}),
            ("mla_dm_b2", "ep", ("data=2,model=2", MLA, {}, fd, b2), {}),
            ("mla_dm_b1", "ep", ("data=2,model=2", MLA, {}, fd, long), {}),
            ("mla_pod_b1", "ep", (POD, MLA, {}, fd, long), {})],
    }


def _ref_cfg(arch, over):
    rcfg = ref_config(arch).smoke()
    if "moe" in over:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, **{f: getattr(over["moe"], f)
                         for f in ("dispatch", "capacity_factor")}))
    return rcfg


def _meshless(flats, params, runs):
    """Per run: the port's meshless tokens and dropped-pair masks, the
    reference's meshless tokens; per serving run the port's and the
    reference's meshless serve tokens."""
    out = {}
    for name, _, (spec, arch, over, flat, toks), kw in \
            [r for w in runs.values() for r in w]:
        tokens, drops = cases.meshless_drops(arch, over, flat, toks)
        rm = ref_build(_ref_cfg(arch, over))
        reng = RefEngine(rm, params[arch], method="quoka")
        want = dict(port=tokens, drops=drops, ref=np.asarray(reng.generate(
            reng.pad_prompt(toks), cases.GEN_NEW).tokens))
        if kw.get("serve") is not None:
            reqs = kw["serve"]
            eng = Engine(ckpt.from_flat(flat, cases.port_cfg(arch, over),
                                        "cpu"), method="quoka", device="cpu")
            want["port_serve"] = eng.serve(make_requests(reqs, 5),
                                           **cases.SERVE_KW).tokens
            want["ref_serve"] = reng.serve(ref_requests(reqs, 5),
                                           **cases.SERVE_KW).tokens
        out[name] = want
    return out


@pytest.fixture(scope="module")
def ep():
    """(name -> every rank's result, name -> the meshless runs)."""
    params, flats = {}, {}
    for arch in (MOE, MLA):
        params[arch] = ref_build(ref_config(arch).smoke()).init(
            jax.random.PRNGKey(0))
        flats[arch] = {k: np.asarray(v)
                       for k, v in _flatten(params[arch]).items()}
    inp = _inputs(ref_config(MOE).smoke().vocab)
    runs = _runs(flats, inp)
    with ThreadPoolExecutor(len(runs)) as pool:
        futs = {w: pool.submit(lm.spawn_ranks, cases.dp_world, w, r,
                               timeout=400) for w, r in runs.items()}
        want = _meshless(flats, params, runs)
        res = {}
        for f in futs.values():
            for rank in f.result():
                for name, r in rank.items():
                    res.setdefault(name, []).append(r)
    return res, want


RUNS = ["moe_m2", "moe_m3", "moe_dm_drop", "moe_dm_serve", "moe_pod_b4",
        "mla_m2", "mla_dm_b2", "mla_dm_b1", "mla_pod_b1"]


@pytest.mark.parametrize("name", RUNS)
def test_tokens_equal_meshless_and_reference(ep, name):
    res, want = ep
    for r in res[name]:                  # every rank, the same tokens
        np.testing.assert_array_equal(r["generate"], want[name]["port"])
        np.testing.assert_array_equal(r["generate"], want[name]["ref"])


@pytest.mark.parametrize("name", RUNS)
def test_shards_reassemble_and_stay_cut(ep, name):
    """Every leaf (deepseek's untied ``lm_head`` and ``mtp/*`` among
    them) reassembles to the meshless model's, and each rank holds its
    placements' bytes."""
    res, _ = ep
    for r in res[name]:
        assert r["reassembled"]
        held, want, whole = r["param_bytes"]
        assert held == want <= whole
        if not name.startswith("moe_m3"):
            assert held < whole


def _fsdp_ranks(name, res):
    """The ranks that split the rows of ``name``'s mesh, in FSDP order
    (``model`` coordinate 0; the mesh's rank order is data-major)."""
    step = 2 if name.startswith("moe_dm") else 1
    return res[name][::step]


@pytest.mark.parametrize("name", ["moe_dm_drop", "moe_pod_b4", "moe_m2",
                                  "moe_m3"])
def test_dropped_pairs_equal_meshless(ep, name):
    """Capacity dispatch at factor 0.5: the meshless run drops pairs, and
    the ranks' rows' dropped pairs, concatenated in rank order, equal its
    own call for call: N and each pair's rank within its expert count
    every rank's rows (at ``model`` alone every rank sees every row)."""
    res, want = ep
    drops = want[name]["drops"]
    if name == "moe_m2":            # the dense dispatch drops nothing
        assert drops == [] and res[name][0]["drops"] == []
        return
    assert sum(int(d.sum()) for d in drops) > 0
    ranks = _fsdp_ranks(name, res) if name != "moe_m3" else res[name][:1]
    split = len(ranks) if name != "moe_m3" else 1
    for i, d in enumerate(drops):
        got = np.concatenate([r["drops"][i] for r in ranks]) if split > 1 \
            else ranks[0]["drops"][i]
        np.testing.assert_array_equal(got, d)
    for r in res[name]:
        assert len(r["drops"]) == len(drops)


def test_experts_held_and_routed_sum_only_when_they_divide(ep):
    """``model=2`` divides 4 experts: a rank holds 2 and the routed
    partial is summed over ``model`` (``ep`` all-reduce: one fp32 (N, d)
    sum a MoE call); ``model=3`` does not: every rank holds all 4 and
    nothing is summed (no ``ep`` collective at all)."""
    res, _ = ep
    cfg = get_config(MOE).smoke()
    # batch 2: three 16-token prefill chunks and 7 decode steps a layer,
    # each all-reduce counted twice its (2 t, d) fp32 bytes
    want = cfg.n_layers * sum(2 * (2 * t) * cfg.d_model * 4
                              for t in [16] * 3 + [1] * (cases.GEN_NEW - 1))
    for r in res["moe_m2"]:
        assert r["experts"] == [2]
        assert r["bytes"]["ep"] == {"all_reduce": want}
    for r in res["moe_m3"]:
        assert r["experts"] == [4]
        assert r["bytes"]["ep"] == {}
    for r in res["moe_dm_drop"]:
        assert r["experts"] == [2]
        # the capacity ranking's (E,) int32 counts cross the data axis
        assert r["bytes"]["ep"].get("all_gather", 0) > 0


def test_moe_serve_on_data_with_prefix_hit_drops_nothing(ep):
    """``data=2,model=2``: the pool's blocks and the step rows split over
    ``data``; at capacity factor E / k no pair can drop (asserted: mesh
    rounding adds pad rows to N, so only there do a serve's drops match a
    meshless serve's), and the serve and its warm prefix hit give the
    meshless tokens."""
    res, want = ep
    w = want["moe_dm_serve"]
    for r in res["moe_dm_serve"]:
        assert r["serve_moe_calls"] > 0 and r["serve_drops"] == 0
        assert r["cache_hits"] > 0
        local, total = r["pool_blocks"]
        assert local * 2 == total
        for i in range(len(w["port_serve"])):
            for key in ("serve", "serve_hit"):
                np.testing.assert_array_equal(r[key][i], w["port_serve"][i])
                np.testing.assert_array_equal(r[key][i], w["ref_serve"][i])
    assert sum(int(d.sum()) for d in w["drops"]) == 0


def test_moe_model2_serve_with_prefix_hit(ep):
    res, want = ep
    w = want["moe_m2"]
    for r in res["moe_m2"]:
        assert r["cache_hits"] > 0
        for i in range(len(w["port_serve"])):
            for key in ("serve", "serve_hit"):
                np.testing.assert_array_equal(r[key][i], w["ref_serve"][i])


def test_mla_model2_plans_equal_reference_on_t_local(ep):
    """Every selecting layer call of deepseek at ``model=2`` takes the
    T-local route (the latent is one KV head, which 2 does not divide):
    each rank scores half the latent; the plan, from every head's
    sub-selected queries, equals the reference's meshless ``plan.build``
    id for id."""
    res, _ = ep
    r0 = res["mla_m2"][0]
    calls = sum(r0["routes"].values())
    assert r0["routes"]["t_local"] == calls > 0
    assert len(r0["records"]) == calls
    qcfg = ref_config(MLA).smoke().quoka
    for rec in r0["records"]:
        assert rec["q"].shape[2] == ref_config(MLA).smoke().n_heads
        got = ref_plan.build(
            "quoka", jnp.asarray(rec["q"]), jnp.asarray(rec["k"]),
            jnp.asarray(rec["key_pos"]), jnp.int32(rec["chunk_start"]),
            qcfg, budget=rec["budget"],
            q_valid=None if rec["q_valid"] is None
            else jnp.asarray(rec["q_valid"]))
        np.testing.assert_array_equal(rec["idx"], np.asarray(got.idx))
    for r in res["mla_m2"]:
        assert r["bytes"]["score"].get("all_gather", 0) > 0


def test_latent_pool_serve_with_prefix_hit(ep):
    """The latent pool on ``model=2`` (every rank writes the whole
    latent): a serve and its warm prefix hit give the meshless tokens."""
    res, want = ep
    w = want["mla_m2"]
    for r in res["mla_m2"]:
        assert r["cache_hits"] > 0
        for i in range(len(w["port_serve"])):
            for key in ("serve", "serve_hit"):
                np.testing.assert_array_equal(r[key][i], w["port_serve"][i])
                np.testing.assert_array_equal(r[key][i], w["ref_serve"][i])


@pytest.mark.parametrize("name,route", [("mla_dm_b1", "seq_t_local"),
                                        ("mla_pod_b1", "seq")])
def test_batch1_latent_sequence_over_data(ep, name, route):
    """Batch 1: each rank holds half the latent's slots and every
    selecting call takes the sequence route (``data=2,model=2``: T-local
    inside each slice, merged over ``model`` then ``data``); the budget's
    latent rows cross once in one buffer (the values are the keys' first
    columns): at most one budget of latent rows and their positions a
    call."""
    res, _ = ep
    cfg = get_config(MLA).smoke()
    width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
    budget = cfg.quoka.budget
    for r in res[name]:
        held, cap = r["slots"]
        assert held * 2 == cap == LONG + cases.GEN_NEW
        calls = sum(r["routes"].values())
        assert r["routes"][route] == calls > 0
        rows = sum(r["bytes"]["seq"].values()) / calls
        assert 0 < rows <= budget * (width * 4 + 4), rows


def test_rows_over_data_mla(ep):
    """Batch 2 at ``data=2,model=2``: rows over ``data``, the whole latent
    on each rank (no sequence split), every call T-local over ``model``."""
    res, _ = ep
    for r in res["mla_dm_b2"]:
        held, cap = r["slots"]
        assert held == cap
        assert r["routes"]["t_local"] == sum(r["routes"].values()) > 0
        assert r["bytes"]["fsdp"]["all_gather"] > 0


def test_latent_cache_shapes_equal_reference():
    """``specs.kv_cache_shapes`` of deepseek gives the reference's latent
    leaves, which ``cache_specs`` places batch over the FSDP axes (or, at
    batch 1, the sequence over ``data``) and never over ``model``."""
    rcfg = ref_config(MLA).smoke()
    rmodel = ref_build(rcfg)
    cache = jax.eval_shape(lambda: rmodel.init_cache(2, 64))
    want = {ref_specs._path_str(p): tuple(x.shape) for p, x in
            jax.tree_util.tree_flatten_with_path(cache)[0]
            if "/latent/" in ref_specs._path_str(p)}
    cfg = get_config(MLA).smoke()
    assert specs.kv_cache_shapes(cfg, 2, 64) == want
    mesh = type("M", (), {"shape": {"data": 2, "model": 2}})()
    for b, seq in ((2, None), (1, "data")):
        place = specs.cache_specs(cfg, specs.kv_cache_shapes(cfg, b, 64),
                                  mesh)
        for key, spec in place.items():
            assert "model" not in spec
            assert spec[1] == (None if b == 1 else "data")
            assert spec[2] == seq


def test_check_mesh_admits_moe_and_mla():
    mesh = type("M", (), {"shape": {"data": 2, "model": 2}})()
    for arch in (MOE, MLA, "whisper-small", "internvl2-1b"):
        ckpt.check_mesh(get_config(arch), mesh)
    odd = dataclasses.replace(get_config(MOE),
                              layer_pattern=("attn_moe", "xattn"))
    with pytest.raises(NotImplementedError) as err:
        ckpt.check_mesh(odd, mesh)
    assert "block kinds ['xattn'] are not placed on a mesh" \
        in str(err.value)
