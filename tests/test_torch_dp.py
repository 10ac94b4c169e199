"""Data-parallel serving of the port on the ``data`` and ``pod`` mesh axes,
against the reference (CPU, fp32, gloo ranks).

One ``launch/mesh.py::spawn_ranks`` per world size, every check of that
world in one module-scoped fixture (the rank bodies are
``tests/torch_tp_cases.py``'s; the three spawns run side by side), while
the reference's and the port's meshless runs go on in this process:

  * ``data=2,model=2`` (4 ranks) and ``data=2,model=4`` (8 ranks, the
    reference's ``test_sharded_serving`` regime: n_kv 2 < 4, the T-local
    route): smoke granite ``generate`` at batch 2 (rows over ``data``),
    ``serve``, and the same serve over the warm pool (``cache_hits > 0``)
    give the port's meshless tokens and the reference's meshless
    ``Engine``'s, for ``full`` and ``quoka``; FSDP-and-model shards
    reassemble to the full leaves, each rank holds its placements'
    parameter bytes (before and after serving), the weights are gathered
    at every layer-stack pass, each rank's pool holds ``N / 2`` blocks;
  * batch 1 with a prompt past budget + chunk at ``data=2`` (2 ranks;
    granularity 1 and 16), ``data=2,model=2`` and ``data=2,model=4``
    (granularity 1): the cache's sequence splits over ``data`` (each rank
    holds ``cap / 2`` slots), every selecting layer call's plan equals
    the reference's meshless ``plan.build`` id for id, a selecting call's
    ``score`` + ``seq`` collectives move under a quarter of the K cache's
    bytes (the reference's bound, ``tests/test_sharded_serving.py``), and
    the tokens equal the meshless ones;
  * ``pod=2,data=2`` (with a size-1 ``model`` axis, 4 ranks): tokens equal
    at batch 4 (rows over ``(pod, data)``) and at batch 1 (the sequence
    over ``data`` only, as ``cache_specs`` places it); ``pod=2,data=2,
    model=2`` (8 ranks): batch 4 over a flattened ``(pod, data)`` group.
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
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config
from repro_torch.launch import mesh as lm
from repro_torch.serving.request import make_requests

import torch_tp_cases as cases

torch.set_num_threads(2)

ARCH = "granite-3-2b"
G16 = {"granularity": 16}
LONG, LONG_NEW = 624, 8        # cap 632 (640 at g 16): past budget 32 +
                               # chunk 16, 2 | cap, 16 | cap / 2 at g 16
POD = "pod=2,data=2,model=1"


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(3, vocab, (n,)).astype(np.int32)
            for n in (16, 48, 29)]


def _long(vocab):
    return np.random.default_rng(7).integers(3, vocab, (LONG,)).astype(
        np.int32)


def _batch4(prompts):
    return np.stack([prompts[1], prompts[1][::-1].copy(),
                     np.roll(prompts[1], 5), np.roll(prompts[1], 11)])


def _runs(flat, prompts, long):
    """Each world's runs (``torch_tp_cases.dp_world``)."""
    over = {}
    seq = lambda spec, method, q=None, rec=False: (
        "seq", (spec, ARCH, over, flat, long, method),
        dict(quoka=q, new=LONG_NEW, record=rec, meshless=False))
    serve = lambda spec: ("serve", (ARCH, over, flat, prompts),
                          dict(spec=spec, meshless=False))
    return {
        2: [("seq_g1",) + seq("data=2", "quoka", rec=True),
            ("seq_g16",) + seq("data=2", "quoka", G16, rec=True),
            ("seq_full",) + seq("data=2", "full")],
        4: [("serve",) + serve("data=2,model=2"),
            ("seq_g1",) + seq("data=2,model=2", "quoka", rec=True),
            ("pod_b4", "gen", (POD, ARCH, over, flat, _batch4(prompts)),
             dict(meshless=False)),
            ("pod_b1_full",) + seq(POD, "full"),
            ("pod_b1_quoka",) + seq(POD, "quoka")],
        8: [("serve",) + serve("data=2,model=4"),
            ("seq_g1",) + seq("data=2,model=4", "quoka", rec=True),
            ("pod_b4", "gen", ("pod=2,data=2,model=2", ARCH, over, flat,
                               _batch4(prompts)), dict(meshless=False))],
    }


def _ref_tokens(rm, params, method, toks, new):
    eng = RefEngine(rm, params, method=method)
    return np.asarray(eng.generate(eng.pad_prompt(toks), new).tokens)


def _meshless(flat, prompts, long):
    """The port's meshless tokens of every run (``port/...``) and the
    reference's (``ref/...``)."""
    from repro_torch.serving.engine import Engine
    from repro_torch.training import checkpoint as ckpt
    rcfg = ref_config(ARCH).smoke()
    rm = ref_build(rcfg)
    params = rm.init(jax.random.PRNGKey(0))
    toks = np.stack([prompts[1], prompts[1][::-1].copy()])
    out = {}
    for method in ("full", "quoka"):
        eng = RefEngine(rm, params, method=method)
        out[f"ref/{method}/generate"] = np.asarray(eng.generate(
            eng.pad_prompt(toks), cases.GEN_NEW).tokens)
        out[f"ref/{method}/serve"] = eng.serve(ref_requests(prompts, 5),
                                               **cases.SERVE_KW).tokens
        out[f"ref/{method}/long"] = _ref_tokens(rm, params, method,
                                                long[None], LONG_NEW)
        out[f"ref/{method}/b4"] = _ref_tokens(rm, params, method,
                                              _batch4(prompts),
                                              cases.GEN_NEW)
    for method, quoka in (("full", None), ("quoka", None),
                          ("quoka", G16)):
        cfg = cases.port_cfg(ARCH, {}, quoka)
        eng = Engine(ckpt.from_flat(flat, cfg, "cpu"), method=method,
                     device="cpu")
        tag = f"port/{method}" + ("/g16" if quoka else "")
        out[f"{tag}/long"] = eng.generate(eng.pad_prompt(long[None]),
                                          LONG_NEW).tokens
        if quoka:
            continue
        out[f"{tag}/generate"] = eng.generate(eng.pad_prompt(toks),
                                              cases.GEN_NEW).tokens
        out[f"{tag}/serve"] = eng.serve(make_requests(prompts, 5),
                                        **cases.SERVE_KW).tokens
        out[f"{tag}/b4"] = eng.generate(eng.pad_prompt(_batch4(prompts)),
                                        cases.GEN_NEW).tokens
    return out


@pytest.fixture(scope="module")
def dp():
    """(the ranks' results by world, the meshless tokens: the port's
    ``port/...`` and the reference's ``ref/...``)."""
    rcfg = ref_config(ARCH).smoke()
    params = ref_build(rcfg).init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    prompts = _prompts(rcfg.vocab)
    long = _long(rcfg.vocab)
    runs = _runs(flat, prompts, long)
    with ThreadPoolExecutor(len(runs)) as pool:
        futs = {w: pool.submit(lm.spawn_ranks, cases.dp_world, w, r,
                               timeout=310) for w, r in runs.items()}
        want = _meshless(flat, prompts, long)
        res = {w: f.result() for w, f in futs.items()}
    return res, want


def _check_serve(res, want):
    for method in ("full", "quoka"):
        for src in ("port", "ref"):
            np.testing.assert_array_equal(
                res[f"{method}/generate_mesh"],
                want[f"{src}/{method}/generate"])
            for i in range(3):
                for key in ("serve_mesh", "serve_hit"):
                    np.testing.assert_array_equal(
                        res[f"{method}/{key}"][i],
                        want[f"{src}/{method}/serve"][i])
        assert res[f"{method}/cache_hits"] > 0


@pytest.mark.parametrize("world", [4, 8])
def test_rows_and_pool_over_data_tokens_equal(dp, world):
    res, want = dp
    for r in res[world]:                  # every rank, the same tokens
        _check_serve(r["serve"], want)
        for method in ("full", "quoka"):
            local, total = r["serve"][f"{method}/pool_blocks"]
            assert local * 2 == total


@pytest.mark.parametrize("world", [4, 8])
def test_fsdp_shards_reassemble_and_stay_cut(dp, world):
    """Every leaf reassembles; each rank holds exactly its placements'
    bytes (about 1 / (data * model) of the cut leaves) before and after
    serving: no gathered weight stays resident."""
    res, _ = dp
    for r in res[world]:
        s = r["serve"]
        assert s["reassembled"]
        held, want, whole = s["param_bytes"]
        assert held == want == s["param_bytes_after"]
        assert held < whole / (world // 2 + 1)


@pytest.mark.parametrize("world", [4, 8])
def test_fsdp_gathers_the_weights_at_every_pass(dp, world):
    """The FSDP all-gathers of a ``generate`` carry at least every
    layer's whole (model-sliced) weights once per layer-stack pass."""
    res, _ = dp
    cfg = get_config(ARCH).smoke()
    d, hd, m = cfg.d_model, cfg.resolved_head_dim, world // 2
    kv = cfg.n_kv_heads * hd // (m if cfg.n_kv_heads % m == 0 else 1)
    layer = 4 * d * (cfg.n_heads * hd // m * 2 + 2 * kv
                     + 3 * cfg.d_ff // m)
    for method in ("full", "quoka"):
        s = res[world][0]["serve"]
        got = s[f"{method}/fsdp_bytes"]["all_gather"]
        assert got >= s[f"{method}/stack_calls"] * cfg.n_layers * layer


def _ref_plan(rec, quoka):
    qcfg = dataclasses.replace(ref_config(ARCH).smoke().quoka,
                               **(quoka or {}))
    got = ref_plan.build(
        "quoka", jnp.asarray(rec["q"]), jnp.asarray(rec["k"]),
        jnp.asarray(rec["key_pos"]), jnp.int32(rec["chunk_start"]), qcfg,
        budget=rec["budget"],
        q_valid=None if rec["q_valid"] is None
        else jnp.asarray(rec["q_valid"]))
    return np.asarray(got.idx)


@pytest.mark.parametrize("world,name,quoka", [
    (2, "seq_g1", None), (2, "seq_g16", G16), (4, "seq_g1", None),
    (8, "seq_g1", None)])
def test_sequence_sharded_plans_equal_reference(dp, world, name, quoka):
    res, _ = dp
    recs = res[world][0][name]["records"]
    cfg = get_config(ARCH).smoke()
    # every layer of the prefill's chunks and the decode steps
    assert len(recs) == cfg.n_layers * (LONG // cfg.quoka.chunk_size
                                        + LONG_NEW - 1)
    for rec in recs:
        np.testing.assert_array_equal(rec["idx"], _ref_plan(rec, quoka))


@pytest.mark.parametrize("world,name", [
    (2, "seq_g1"), (2, "seq_g16"), (4, "seq_g1"), (8, "seq_g1")])
def test_sequence_sharded_cache_moves_candidates_and_budget_rows(
        dp, world, name):
    """Each rank holds ``cap / 2`` slots of every layer's cache; a
    selecting call's scoring and budget-row collectives move under a
    quarter of the layer's K cache bytes, the budget rows no more than one
    budget's K, V and positions of the rank's KV heads; every call took
    the sequence route (with the T-local split inside where n_kv 2 <
    model 4)."""
    res, _ = dp
    for r in res[world]:
        s = r[name]
        assert s["slots"] == [s["cap"] // 2] * len(s["slots"])
        calls = s["routes"]["seq"] + s["routes"]["seq_t_local"]
        assert calls == sum(s["routes"].values()) > 0
        if world == 8:
            assert s["routes"]["seq_t_local"] == calls
        moved = sum(s["bytes"]["score"].values()) + \
            sum(s["bytes"]["seq"].values())
        assert 0 < moved / calls < s["k_bytes"] / 4, (moved / calls,
                                                       s["k_bytes"])
        rows = sum(s["bytes"]["seq"].values()) / calls
        assert 0 < rows <= s["budget_bytes"], (rows, s["budget_bytes"])


@pytest.mark.parametrize("world,name,method", [
    (2, "seq_g1", "quoka"), (2, "seq_full", "full"), (4, "seq_g1", "quoka"),
    (8, "seq_g1", "quoka"), (2, "seq_g16", "quoka/g16"),
    (4, "pod_b1_full", "full"), (4, "pod_b1_quoka", "quoka")])
def test_batch1_tokens_equal_meshless_and_reference(dp, world, name, method):
    res, want = dp
    for r in res[world]:
        s = r[name]
        np.testing.assert_array_equal(s["generate_mesh"],
                                      want[f"port/{method}/long"])
        if "g16" not in method:
            np.testing.assert_array_equal(s["generate_mesh"],
                                          want[f"ref/{method}/long"])


@pytest.mark.parametrize("world", [4, 8])
def test_pod_and_data_rows_tokens_equal(dp, world):
    """Batch 4 with rows over ``(pod, data)``: on ``pod=2,data=2`` (one
    FSDP group, the whole world) and ``pod=2,data=2,model=2`` (a
    flattened group per ``model`` rank); batch 1 on ``pod=2,data=2``
    splits the sequence over ``data`` only (``pod`` replicates)."""
    res, want = dp
    for r in res[world]:
        for method in ("full", "quoka"):
            mesh = r["pod_b4"][method][1]
            np.testing.assert_array_equal(mesh, want[f"port/{method}/b4"])
            np.testing.assert_array_equal(mesh, want[f"ref/{method}/b4"])
    if world == 4:
        s = res[4][0]["pod_b1_quoka"]
        assert s["slots"] == [s["cap"] // 2] * len(s["slots"])
