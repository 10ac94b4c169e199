"""The sliding-window and recurrent block kinds of the port on the
``model``, ``data`` and ``pod`` mesh axes, against the reference (CPU,
fp32, gloo ranks).

One ``launch/mesh.py::spawn_ranks`` per world size (2, 3 and 4 ranks,
side by side; the rank body is ``tests/torch_tp_cases.py::kinds_case``),
while the reference's and the port's meshless runs go on in this
process, on the reference's flat weights:

  * gemma3-27b smoke (5 : 1 local : global, a ring of 64 slots) at
    ``model=2`` with a prompt that wraps the ring, and h2o-danube-3-4b
    smoke (every layer windowed) at ``model=2``: the windowed layers
    select on their rank's KV heads of the ring;
  * zamba2-7b smoke (a Mamba2 layer and one with the shared attention
    block) at ``model=2`` (the SSD heads, the gated norm's sum over
    ``model``, the row-parallel ``out_proj``), at ``data=2,model=2``
    batch 2 (rows over ``data``, FSDP weight gathers) and at ``model=3``,
    which divides neither the attention heads nor the SSD heads: the
    reference's rule drops the axis and every leaf stays whole, the shared
    block's replicated KV cache takes the T-local route;
  * rwkv6-1.6b smoke at ``model=2`` (the wkv heads, ``tm/wr`` whole,
    ``cm``'s gathers) and at ``pod=2,data=2`` batch 4;
  * gemma3 at ``data=2,model=2`` batch 1: every KV cache, the wrapping
    ring among them, holds half its slots on each ``data`` rank; every
    selecting layer call's plan equals the reference's meshless
    ``plan.build`` id for id.

In every world the tokens equal the port's meshless run and the
reference's meshless ``Engine``; every sharded leaf reassembles to the
meshless model's and each rank holds its placements' parameter bytes;
each cache leaf holds the bytes ``cache_specs`` places on the rank,
except a Mamba2 convolution tail, which holds the rank's x channels and
the whole B / C channels (the reference cuts the concatenation at its
midpoint).
"""
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
from repro.sharding import specs as ref_specs
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config
from repro_torch.launch import mesh as lm
from repro_torch.serving.engine import Engine
from repro_torch.sharding import specs
from repro_torch.training import checkpoint as ckpt

import torch_tp_cases as cases

torch.set_num_threads(2)

GEMMA, DANUBE = "gemma3-27b", "h2o-danube-3-4b"
ZAMBA, RWKV = "zamba2-7b", "rwkv6-1.6b"
ARCHS = (GEMMA, DANUBE, ZAMBA, RWKV)
POD = "pod=2,data=2,model=1"
WRAP = 96           # past the smoke ring of 64 slots; budget 32 + chunk 16
SHORT = 64


def _inputs(vocab):
    rng = np.random.default_rng(11)
    # 64 + 8 new: a 72-slot cache that 3 divides (24 slots a rank)
    b2 = rng.integers(3, vocab, (2, SHORT)).astype(np.int32)
    b4 = np.concatenate([b2, np.roll(b2, 7, axis=1)])
    wrap = rng.integers(3, vocab, (2, WRAP)).astype(np.int32)
    return b2, b4, wrap


def _runs(flats, inp):
    """Each world's runs (``torch_tp_cases.dp_world``):
    (name, "kinds", (spec, arch, over, flat, toks), kw)."""
    b2, b4, wrap = inp
    run = lambda name, spec, arch, toks, **kw: (
        name, "kinds", (spec, arch, {}, flats[arch], toks), kw)
    return {
        2: [run("gemma_m2", "model=2", GEMMA, wrap),
            run("danube_m2", "model=2", DANUBE, wrap),
            run("zamba_m2", "model=2", ZAMBA, b2),
            run("rwkv_m2", "model=2", RWKV, b2),
            ("mamba_call", "mamba_call", ("model=2",), {})],
        3: [run("zamba_m3", "model=3", ZAMBA, b2)],
        4: [run("zamba_dm", "data=2,model=2", ZAMBA, b2),
            run("rwkv_pod", POD, RWKV, b4),
            run("gemma_b1", "data=2,model=2", GEMMA, wrap[:1], record=True)],
    }


def _meshless(flats, params, runs):
    """Per run: the port's and the reference's meshless tokens (once per
    arch and batch)."""
    out, done, ref_engines = {}, {}, {}
    for name, case, args, kw in [r for w in runs.values() for r in w]:
        if case != "kinds":
            continue
        spec, arch, over, flat, toks = args
        key = (arch, toks.tobytes())
        if key not in done:
            eng = Engine(ckpt.from_flat(flat, cases.port_cfg(arch, over),
                                        "cpu"), method="quoka", device="cpu")
            if arch not in ref_engines:
                ref_engines[arch] = RefEngine(
                    ref_build(ref_config(arch).smoke()), params[arch],
                    method="quoka")
            reng = ref_engines[arch]
            done[key] = dict(
                port=eng.generate(eng.pad_prompt(toks), cases.GEN_NEW).tokens,
                ref=np.asarray(reng.generate(reng.pad_prompt(toks),
                                             cases.GEN_NEW).tokens))
        out[name] = done[key]
    return out


@pytest.fixture(scope="module")
def kinds():
    """(name -> every rank's result, name -> the meshless runs)."""
    params, flats = {}, {}
    for arch in ARCHS:
        params[arch] = ref_build(ref_config(arch).smoke()).init(
            jax.random.PRNGKey(0))
        flats[arch] = {k: np.asarray(v)
                       for k, v in _flatten(params[arch]).items()}
    runs = _runs(flats, _inputs(ref_config(GEMMA).smoke().vocab))
    with ThreadPoolExecutor(len(runs)) as pool:
        futs = {w: pool.submit(lm.spawn_ranks, cases.dp_world, w, r,
                               timeout=240) for w, r in runs.items()}
        want = _meshless(flats, params, runs)
        res = {}
        for f in futs.values():
            for rank in f.result():
                for name, r in rank.items():
                    res.setdefault(name, []).append(r)
    return res, want


RUNS = ["gemma_m2", "danube_m2", "zamba_m2", "rwkv_m2", "zamba_m3",
        "zamba_dm", "rwkv_pod", "gemma_b1"]


@pytest.mark.parametrize("name", RUNS)
def test_tokens_equal_meshless_and_reference(kinds, name):
    res, want = kinds
    np.testing.assert_array_equal(want[name]["port"], want[name]["ref"])
    for r in res[name]:                  # every rank, the same tokens
        np.testing.assert_array_equal(r["generate"], want[name]["port"])


@pytest.mark.parametrize("name", RUNS)
def test_shards_reassemble_and_stay_cut(kinds, name):
    """Every leaf reassembles to the meshless model's, and each rank holds
    its placements' bytes (at ``model=3`` all of them: nothing divides)."""
    res, _ = kinds
    for r in res[name]:
        assert r["reassembled"]
        held, want, whole = r["param_bytes"]
        assert held == want <= whole
        assert (held == whole) == (name == "zamba_m3")


@pytest.mark.parametrize("name", RUNS)
def test_cache_leaves_hold_their_placement(kinds, name):
    """Each cache leaf holds what ``cache_specs`` places on the rank,
    except a Mamba2 convolution tail: the rank's x channels and the
    whole B and C channels, where the reference cuts the concatenated
    ``[x | B | C]`` axis at its midpoint, off the heads."""
    res, _ = kinds
    arch = {"gemma": GEMMA, "danube": DANUBE, "zamba": ZAMBA,
            "rwkv": RWKV}[name.split("_")[0]]
    cfg = get_config(arch).smoke()
    msize = {"zamba_m3": 3}.get(name, 1 if name == "rwkv_pod" else 2)
    for r in res[name]:
        cb = r["cache_bytes"]
        for leaf, (held, want) in cb.items():
            if leaf != "mamba/conv" or msize == 3:
                assert held == want, (leaf, held, want)
        if "mamba/conv" in cb and msize == 2:
            s = cfg.ssm
            di = s.expand * cfg.d_model
            rows = 1 if name == "zamba_dm" else 2
            per = rows * (s.d_conv - 1) * 4            # fp32, per channel
            held, want = cb["mamba/conv"]
            assert held == cfg.n_layers * per * (di // 2 + 2 * s.d_state)
            assert want == cfg.n_layers * per * (di + 2 * s.d_state) // 2


def test_windowed_layers_select_on_their_heads(kinds):
    """gemma3 and h2o-danube at ``model=2``: the KV heads divide, so every
    selecting call scores this rank's own KV heads of its ring (or
    cache); the ring holds min(cap, window) = 64 slots; the row-parallel
    sums and the logits' gather count under the default scope."""
    res, _ = kinds
    for name in ("gemma_m2", "danube_m2"):
        for r in res[name]:
            calls = sum(r["routes"].values())
            assert r["routes"]["kv_heads"] == calls > 0, r["routes"]
            assert (64, 64) in r["slots"]
            assert r["bytes"][""]["all_reduce"] > 0


def test_zamba2_shared_block_routes(kinds):
    """The shared block's caches select on their own KV heads at
    ``model=2`` (MHA 4 / 2), and on the T-local route at ``model=3``,
    where its heads stay whole (4 % 3) and the 72-slot cache splits in
    three."""
    res, _ = kinds
    for name, route in (("zamba_m2", "kv_heads"), ("zamba_m3", "t_local"),
                        ("zamba_dm", "kv_heads")):
        for r in res[name]:
            calls = sum(r["routes"].values())
            assert r["routes"][route] == calls > 0, (name, r["routes"])
    for r in res["zamba_m3"]:
        assert r["bytes"][""].get("all_reduce", 0) == 0  # nothing is cut
        assert r["bytes"]["score"]["all_gather"] > 0


def test_recurrent_collectives_per_layer_call(kinds):
    """The default scope's bytes at ``model=2``, batch 2, four prefill
    chunks of 16 and 7 decode steps (an all-reduce counts twice its
    bytes, an all-gather its result): the vocab-parallel embedding's fp32
    (b, t, d) sum and the logits' gather at every step; per Mamba2 layer
    call ``out_proj``'s fp32 (b, t, d) sum and the gated norm's fp32 (b,
    t) sum of squares; per shared-block use ``wo``'s and the MLP's fp32
    (b, t, d) sums; per RWKV6 layer call ``tm/wo``'s fp32 (b, t, d) sum
    and the channel mix's gathers of the (b, t, d_ff) squared activations
    and the (b, t, d) outputs."""
    res, _ = kinds
    bt = 2 * (SHORT + cases.GEN_NEW - 1)            # rows x tokens
    steps = 1 + cases.GEN_NEW - 1                   # read-outs
    zc = get_config(ZAMBA).smoke()
    d = zc.d_model
    want = {"all_reduce": 2 * bt * 4 * (d + zc.n_layers * (d + 1)
                                        + 2 * d),
            "all_gather": steps * 2 * zc.vocab * 4}
    for r in res["zamba_m2"]:
        assert r["bytes"][""] == want
    rc = get_config(RWKV).smoke()
    d = rc.d_model
    want = {"all_reduce": 2 * bt * 4 * d * (1 + rc.n_layers),
            "all_gather": rc.n_layers * bt * 4 * (rc.d_ff + d)
            + steps * 2 * rc.vocab * 4}
    for r in res["rwkv_m2"]:
        assert r["bytes"][""] == want


def test_batch1_ring_over_data_plans_equal_reference(kinds):
    """gemma3 at ``data=2,model=2`` batch 1: each rank holds half of every
    KV cache's slots, the 64-slot ring (written past a lap) among them;
    every selecting call takes the sequence route on its own KV heads,
    and its plan, from whole inputs, equals the reference's meshless
    ``plan.build`` id for id: candidates merge by slot, whatever order
    the positions have in a wrapped ring."""
    res, _ = kinds
    for r in res["gemma_b1"]:
        assert all(held * 2 == cap for held, cap in r["slots"])
        assert (32, 64) in r["slots"]
        calls = sum(r["routes"].values())
        assert r["routes"]["seq"] == calls > 0, r["routes"]
        assert sum(r["bytes"]["seq"].values()) > 0
    r0 = res["gemma_b1"][0]
    assert len(r0["records"]) == calls
    wrapped = 0
    qcfg = ref_config(GEMMA).smoke().quoka
    for rec in r0["records"]:
        kp = rec["key_pos"]
        wrapped += bool((np.diff(kp[kp >= 0]) < 0).any()) if \
            kp.shape[1] == 64 else 0
        got = ref_plan.build(
            "quoka", jnp.asarray(rec["q"]), jnp.asarray(rec["k"]),
            jnp.asarray(rec["key_pos"]), jnp.int32(rec["chunk_start"]),
            qcfg, budget=rec["budget"],
            q_valid=None if rec["q_valid"] is None
            else jnp.asarray(rec["q_valid"]))
        np.testing.assert_array_equal(rec["idx"], np.asarray(got.idx))
    assert wrapped > 0


def test_rows_over_data_gather_weights(kinds):
    """``data=2,model=2`` batch 2 (zamba2) and ``pod=2,data=2`` batch 4
    (rwkv6): rows split over the FSDP group, whose weight shards are
    gathered at every layer call."""
    res, _ = kinds
    for name in ("zamba_dm", "rwkv_pod"):
        for r in res[name]:
            assert r["bytes"]["fsdp"]["all_gather"] > 0


def test_mamba_layer_call_on_model2_matches_meshless(kinds):
    """One smoke zamba2 Mamba2 call at ``model=2`` from a nonzero state
    (``torch_tp_cases.mamba_call_case``): each rank's 8 of 16 SSD heads,
    its 256 x channels and the 32 B / C channels in the tail; output, new
    state and tail equal the meshless call's (fp32 sums in another order);
    the only collectives are the gated norm's (b, t) and ``out_proj``'s
    (b, t, d) fp32 sums."""
    res, _ = kinds
    d = get_config(ZAMBA).smoke().d_model
    for r in res["mamba_call"]:
        assert r["rel"] <= 1e-5 and r["ssd"] <= 1e-5 and r["conv"] == 0, r
        assert (r["heads"], r["tail"]) == (8, 256 + 32)
        assert r["bytes"] == {"all_reduce": 2 * 2 * 24 * 4 * (d + 1)}


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_equal_reference(arch):
    """``specs.kv_cache_shapes`` gives the reference's cache leaves (a
    ring at min(cap, window); Mamba2's conv and SSD state, zamba2's shared
    block's KV; RWKV6's shifts and wkv state), which ``cache_specs``
    places as the reference places them."""
    rcfg = ref_config(arch).smoke()
    rmodel = ref_build(rcfg)
    cfg = get_config(arch).smoke()
    for b, cap in ((2, 128), (1, 128)):
        cache = jax.eval_shape(lambda: rmodel.init_cache(b, cap))
        flat = jax.tree_util.tree_flatten_with_path(cache)[0]
        want = {ref_specs._path_str(p): tuple(x.shape) for p, x in flat
                if ref_specs._path_str(p) != "enc_done"}
        assert specs.kv_cache_shapes(cfg, b, cap) == want
