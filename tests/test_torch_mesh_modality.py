"""The modality families of the port on the ``model``, ``data`` and ``pod``
mesh axes, and serve-path telemetry (``Engine(mesh=, registry=)``) on a
mesh, against the reference (CPU, fp32, gloo ranks).

One ``launch/mesh.py::spawn_ranks`` per world size (2, 3 and 4 ranks, side
by side; the rank bodies are ``tests/torch_tp_cases.py::modality_case``
and ``registry_case``), while the reference's and the port's meshless
runs go on in this process, on the reference's flat weights:

  * whisper-small smoke (a 2-layer encoder over 64 stub frames, two
    ``dec_cross`` layers) and internvl2-1b smoke (16 projected patches
    ahead of the tokens, GQA 4 / 2) at ``model=2`` (every head axis
    shards; internvl2's one KV head a rank: the ``kv_heads`` route), at
    ``model=3`` (nothing divides: every head replicated, T-local
    scoring), at ``data=2,model=2`` batch 2 (rows over ``data``, FSDP
    weight gathers, the projector's among them) and batch 1 (whisper's
    32 frames a rank in each ``CrossKV``, merged exactly; internvl2's KV
    cache's sequence split), and at ``pod=2,data=2`` batch 4;
  * granite smoke served with a registry, cold then with prefix hits, at
    ``model=2`` and ``model=3`` for ``full`` and ``quoka``: the registry
    equals the port's meshless registry and the reference's
    (``test_torch_obs.py::_same_registry``); at ``data=2,model=2`` every
    counter equals the meshless run's.

In every modality world the tokens equal the port's meshless run and the
reference's meshless ``Engine``; every sharded leaf reassembles to the
meshless model's and each rank holds its placements' parameter bytes;
each cache leaf (the cross keys and values among them) holds the bytes
``cache_specs`` places on the rank, and ``cache_specs`` equals the
reference's on the reference's cache leaves at batch 2 and 1; a cross
cache written under a wrong head or frame mapping moves the logits.
"""
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.configs import get_config as ref_config
from repro.models.model import build_model as ref_build
from repro.serving.engine import Engine as RefEngine
from repro.serving.request import make_requests as ref_requests
from repro.sharding import specs as ref_specs
from repro.training.checkpoint import _flatten
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.launch import mesh as lm
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import make_requests
from repro_torch.sharding import specs
from repro_torch.training import checkpoint as ckpt

import torch_tp_cases as cases
from test_torch_obs import _same_registry

torch.set_num_threads(2)

WHISPER, INTERN, GRANITE = "whisper-small", "internvl2-1b", "granite-3-2b"
ARCHS = (WHISPER, INTERN)
POD = "pod=2,data=2,model=1"
# 112 positions + 8 new: a 120-slot cache that 2 and 3 divide, past the
# budget 32 + chunk 16, so every chunk from the third selects
POSITIONS = 112
SERVE_KW = dict(block_size=16, max_decode_batch=4)


class FakeMesh:
    """Just enough mesh surface for placement (no devices needed)."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _batch(cfg, b, seed):
    """A ``POSITIONS``-position prompt of ``b`` rows: tokens and
    whisper's frames (b, n_ctx, d) or the VLM's patches (b, n, d_in)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(3, cfg.vocab, (
        b, POSITIONS - cfg.prefix_positions)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    else:
        out["patches"] = rng.standard_normal(
            (b, cfg.frontend.n_tokens, cfg.frontend.d_in)).astype(np.float32)
    return out


def _reg_prompts(vocab, shared):
    """Three prompts sharing a 48-token prefix (``shared``), or two
    distinct 64-token ones, whose second serve hits its own blocks on its
    own ``data`` rank, so the data-parallel schedule is the meshless one."""
    rng = np.random.default_rng(7)
    if not shared:
        return [rng.integers(3, vocab, (64,)).astype(np.int32)
                for _ in range(2)]
    sys_tok = rng.integers(3, vocab, (48,)).astype(np.int32)
    return [np.concatenate([sys_tok, rng.integers(3, vocab, (16,)).astype(
        np.int32)]) for _ in range(3)]


def _runs(flats, batches, prompts):
    """Each world's runs (``torch_tp_cases.dp_world``)."""
    mod = lambda name, spec, arch, b, **kw: (
        name, "modality", (spec, arch, {}, flats[arch], batches[arch, b]),
        kw)
    reg = lambda name, spec, p: (name, "registry",
                                 (spec, GRANITE, flats[GRANITE], p), {})
    return {
        2: [mod("whisper_m2", "model=2", WHISPER, 2, mutant="heads"),
            mod("intern_m2", "model=2", INTERN, 2),
            reg("reg_m2", "model=2", prompts[True]),
            ("whisper_call", "whisper_call", ("model=2",), {})],
        3: [mod("whisper_m3", "model=3", WHISPER, 2),
            mod("intern_m3", "model=3", INTERN, 2),
            reg("reg_m3", "model=3", prompts[True])],
        4: [mod("whisper_dm", "data=2,model=2", WHISPER, 2),
            mod("intern_dm", "data=2,model=2", INTERN, 2),
            mod("whisper_b1", "data=2,model=2", WHISPER, 1, mutant="frames"),
            mod("intern_b1", "data=2,model=2", INTERN, 1),
            mod("whisper_pod", POD, WHISPER, 4),
            mod("intern_pod", POD, INTERN, 4),
            reg("reg_dm", "data=2,model=2", prompts[False])],
    }


def _meshless(flats, params, batches):
    """Per (arch, batch): the port's and the reference's meshless tokens
    and the port's first-step logits."""
    out = {}
    for arch in ARCHS:
        cfg = cases.port_cfg(arch, {})
        model = ckpt.from_flat(flats[arch], cfg, "cpu")
        eng = Engine(model, method="quoka", device="cpu")
        reng = RefEngine(ref_build(ref_config(arch).smoke()), params[arch],
                         method="quoka")
        for b in (1, 2, 4):
            batch = batches[arch, b]
            logits, _ = model.prefill(batch, model.init_cache(
                b, POSITIONS + cases.GEN_NEW), "quoka")
            out[arch, b] = dict(
                port=eng.generate(batch, cases.GEN_NEW).tokens,
                ref=np.asarray(reng.generate(
                    {k: jnp.asarray(v) for k, v in batch.items()},
                    cases.GEN_NEW).tokens),
                logits=logits.numpy())
    return out


def _serve_registries(flat, params, prompts):
    """{(shared, method): (the port's meshless registry, the reference's,
    the port's tokens)} of the cold + warm serve ``registry_case``
    runs."""
    cfg = cases.port_cfg(GRANITE, {})
    rm = ref_build(ref_config(GRANITE).smoke())
    out = {}
    for shared, ps in prompts.items():
        for method in ("full", "quoka"):
            preg = obs.Registry()
            eng = Engine(ckpt.from_flat(flat, cfg, "cpu"), method=method,
                         device="cpu", registry=preg)
            st = eng.make_serve_state(make_requests(ps, 5), **SERVE_KW)
            toks = [eng.serve(make_requests(ps, 5), state=st).tokens
                    for _ in range(2)]
            rreg = None
            if shared:
                rreg = ref_obs.Registry()
                reng = RefEngine(rm, params, method=method, registry=rreg)
                rst = reng.make_serve_state(ref_requests(ps, 5), **SERVE_KW)
                for _ in range(2):
                    reng.serve(ref_requests(ps, 5), state=rst)
            out[shared, method] = (preg, rreg, [
                {r: t.tolist() for r, t in x.items()} for x in toks])
    return out


@pytest.fixture(scope="module")
def mm():
    """(name -> every rank's result, (arch, batch) -> the meshless runs,
    (shared, method) -> the meshless registries)."""
    params, flats = {}, {}
    for arch in ARCHS + (GRANITE,):
        params[arch] = ref_build(ref_config(arch).smoke()).init(
            jax.random.PRNGKey(0))
        flats[arch] = {k: np.asarray(v)
                       for k, v in _flatten(params[arch]).items()}
    batches = {(arch, b): _batch(get_config(arch).smoke(), b, 11 + b)
               for arch in ARCHS for b in (1, 2, 4)}
    vocab = get_config(GRANITE).smoke().vocab
    prompts = {s: _reg_prompts(vocab, s) for s in (True, False)}
    runs = _runs(flats, batches, prompts)
    with ThreadPoolExecutor(len(runs)) as pool:
        futs = {w: pool.submit(lm.spawn_ranks, cases.dp_world, w, r,
                               timeout=300) for w, r in runs.items()}
        want = _meshless(flats, params, batches)
        regs = _serve_registries(flats[GRANITE], params[GRANITE], prompts)
        res = {}
        for f in futs.values():
            for rank in f.result():
                for name, r in rank.items():
                    res.setdefault(name, []).append(r)
    return res, want, regs


MOD = {"whisper_m2": (WHISPER, 2), "intern_m2": (INTERN, 2),
       "whisper_m3": (WHISPER, 2), "intern_m3": (INTERN, 2),
       "whisper_dm": (WHISPER, 2), "intern_dm": (INTERN, 2),
       "whisper_b1": (WHISPER, 1), "intern_b1": (INTERN, 1),
       "whisper_pod": (WHISPER, 4), "intern_pod": (INTERN, 4)}


@pytest.mark.parametrize("name", sorted(MOD))
def test_tokens_equal_meshless_and_reference(mm, name):
    res, want, _ = mm
    w = want[MOD[name]]
    np.testing.assert_array_equal(w["port"], w["ref"])
    for r in res[name]:                  # every rank, the same tokens
        np.testing.assert_array_equal(r["generate"], w["port"])
        np.testing.assert_allclose(r["logits"], w["logits"], rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("name", sorted(MOD))
def test_shards_reassemble_and_stay_cut(mm, name):
    """Every leaf (the encoder's, the cross weights and the projector's
    among them) reassembles to the meshless model's, and each rank holds
    its placements' bytes (at ``model=3`` all of them: nothing
    divides)."""
    res, _, _ = mm
    for r in res[name]:
        assert r["reassembled"]
        held, want, whole = r["param_bytes"]
        assert held == want <= whole
        assert (held == whole) == name.endswith("_m3")


@pytest.mark.parametrize("name", sorted(MOD))
def test_cache_leaves_hold_their_placement(mm, name):
    """Each cache leaf, whisper's ``cross/{k,v}`` among them, holds the
    bytes ``cache_specs`` places on the rank; at batch 1 each ``data``
    rank holds half of the self-attention's slots and of the encoder's
    frames."""
    res, _, _ = mm
    arch, b = MOD[name]
    cfg = get_config(arch).smoke()
    for r in res[name]:
        cb = r["cache_bytes"]
        assert set(cb) >= {"kv/k", "kv/v", "kv/pos"}
        assert ("cross/k" in cb) == (arch == WHISPER)
        for leaf, (held, want) in cb.items():
            assert held == want, (leaf, held, want)
        split = 2 if b == 1 else 1
        assert all(held * split == cap for held, cap in r["slots"])
        assert r["frames"] == ([cfg.encoder.n_ctx // split] * cfg.n_layers
                               if arch == WHISPER else [])


def test_routes_per_mesh(mm):
    """Every selecting call of a world takes one route: this rank's KV
    heads at ``model=2`` and ``data=2,model=2`` batch 2, the T-local
    route at ``model=3`` (4 query and 4 / 2 KV heads on 3 ranks: all
    replicated), the sequence route at batch 1, every KV head on the
    replicated cache at ``pod=2,data=2`` (a ``model`` axis of 1)."""
    res, _, _ = mm
    want = {"m2": "kv_heads", "dm": "kv_heads", "m3": "t_local",
            "b1": "seq", "pod": "replicated"}
    for name in MOD:
        for r in res[name]:
            calls = sum(r["routes"].values())
            assert r["routes"][want[name.split("_")[1]]] == calls > 0, \
                (name, r["routes"])


def test_batch1_cross_merge_bytes(mm):
    """whisper at ``data=2,model=2`` batch 1: each cross-attention call
    all-gathers each rank's fp32 (b, t, h_local, hd + 2) partial output,
    row max and row sum over ``data`` once; the cross keys and values
    never move."""
    res, _, _ = mm
    cfg = get_config(WHISPER).smoke()
    hd, h = cfg.resolved_head_dim, cfg.n_heads // 2
    chunks = POSITIONS // cfg.quoka.chunk_size
    rows = chunks * cfg.quoka.chunk_size + cases.GEN_NEW - 1
    want = cfg.n_layers * rows * h * (hd + 2) * 4 * 2
    for r in res["whisper_b1"]:
        assert r["bytes"]["cross"] == {"all_gather": want}
    for name in ("whisper_m2", "whisper_dm", "whisper_m3", "whisper_pod"):
        for r in res[name]:
            assert r["bytes"]["cross"] == {}


def test_rows_over_fsdp_gather_weights(mm):
    """Rows split over the FSDP group (``data=2,model=2`` batch 2,
    ``pod=2,data=2`` batch 4): the layers' weights, the encoder's and the
    projector's included, are gathered per call."""
    res, _, _ = mm
    for name in ("whisper_dm", "intern_dm", "whisper_pod", "intern_pod"):
        for r in res[name]:
            assert r["bytes"]["fsdp"]["all_gather"] > 0


@pytest.mark.parametrize("name,kind", [("whisper_m2", "heads"),
                                       ("whisper_b1", "frames")])
def test_wrong_cross_mapping_moves_the_logits(mm, name, kind):
    """The same prefill with each rank's ``CrossKV`` written under a
    wrong mapping (its KV heads reversed; every rank the first rank's
    frames) gives first-step logits far from the meshless ones, which
    the right mapping meets within 1e-4."""
    res, want, _ = mm
    w = want[MOD[name]]["logits"]
    for r in res[name]:
        assert np.abs(r["logits"] - w).max() <= 1e-4
        assert np.abs(r["mutant_logits"] - w).max() > 1e-2, kind


def test_whisper_call_on_model2_matches_meshless(mm):
    """``torch_tp_cases.whisper_call_case`` (the rank body of
    ``test_torch_cuda.py``'s card test) on the CPU: a smoke whisper
    prefill and decode step at ``model=2``, each rank's 2 of 4 query and
    KV heads in the self- and the cross-attention, equal the meshless
    calls within 1e-5 of the largest logit."""
    res, _, _ = mm
    for r in res["whisper_call"]:
        assert r["rel"] <= 1e-5, r
        assert (r["heads"], r["cross_kv"]) == (2, 2)
        assert r["bytes"]["all_reduce"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch):
    """``specs.kv_cache_shapes`` gives the reference's cache leaves (a
    ``dec_cross`` layer's ``kv/*`` and ``cross/{k,v}``), which
    ``cache_specs`` places as the reference's does at batch 2 and 1:
    the cross leaves meet the ``/(k|v)$`` rule first, so at batch 1
    their frames go over ``data``."""
    rcfg = ref_config(arch).smoke()
    rmodel = ref_build(rcfg)
    cfg = get_config(arch).smoke()
    mesh = FakeMesh({"data": 2, "model": 2})
    for b in (2, 1):
        cache = jax.eval_shape(lambda: rmodel.init_cache(b, 120))
        flat = jax.tree_util.tree_flatten_with_path(cache)[0]
        shapes = {ref_specs._path_str(p): tuple(x.shape) for p, x in flat
                  if ref_specs._path_str(p) != "enc_done"}
        assert specs.kv_cache_shapes(cfg, b, 120) == shapes
        spec = ref_specs.cache_specs(rcfg, cache, mesh)
        flat = jax.tree_util.tree_flatten_with_path(
            spec, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
        )[0]
        want = {ref_specs._path_str(p): tuple(s) for p, s in flat
                if ref_specs._path_str(p) != "enc_done"}
        got = specs.cache_specs(cfg, shapes, mesh)
        assert got == want
        for key, s in got.items():
            if "/cross/" in key:
                assert s == (None, "data" if b == 2 else None,
                             "data" if b == 1 else None, "model", None)


def _registry(snap):
    """A ``registry_case`` snapshot with the attributes
    ``_same_registry`` reads."""
    hist = lambda c, s: SimpleNamespace(count=c, summary=lambda: s)
    return SimpleNamespace(
        counters={k: SimpleNamespace(value=v)
                  for k, v in snap["counters"].items()},
        gauges={k: SimpleNamespace(value=v)
                for k, v in snap["gauges"].items()},
        histograms={k: hist(*v) for k, v in snap["hists"].items()})


@pytest.mark.parametrize("name", ["reg_m2", "reg_m3"])
@pytest.mark.parametrize("method", ["full", "quoka"])
def test_mesh_registry_equals_meshless_and_reference(mm, name, method):
    """granite smoke at ``model=2`` / ``model=3``, a cold serve then one
    with three prefix hits: every rank's registry (counters, gauges, the
    per-layer ``kv_fraction`` among them, non-time histogram summaries)
    equals the port's meshless registry and the reference's, and its
    tokens the meshless ones."""
    res, _, regs = mm
    preg, rreg, toks = regs[True, method]
    for r in res[name]:
        got = r[method, True]
        assert got["tokens"] == toks
        _same_registry(_registry(got["registry"]), preg)
        _same_registry(_registry(got["registry"]), rreg)
        assert got["registry"]["counters"][
            "sched/prefix_hit_requests"] == 3


def test_mesh_registry_counters_on_a_data_axis(mm):
    """``data=2,model=2``: two requests, one a rank, served cold and then
    each hitting its own blocks; every rank's counters equal the meshless
    run's (each request counted once), and every layer's selected-KV
    fraction stays within its budget fraction."""
    res, _, regs = mm
    for method in ("full", "quoka"):
        preg, _, toks = regs[False, method]
        want = {k: c.value for k, c in preg.counters.items()}
        for r in res["reg_dm"]:
            got = r[method, True]
            assert got["tokens"] == toks
            snap = got["registry"]
            assert snap["counters"] == want
            assert snap["counters"]["sched/prefix_hit_requests"] == 2
            g = snap["gauges"]
            layer = [k for k in g if k.endswith("/kv_fraction")]
            bud = [k.replace("kv_fraction", "budget_fraction")
                   for k in layer]
            assert layer and all((b in g) == (method == "quoka")
                                 for b in bud)
            for k, b in zip(layer, bud):
                assert g[k] <= g.get(b, 1.0) + 1e-6


@pytest.mark.parametrize("name", ["reg_m2", "reg_m3", "reg_dm"])
def test_registry_on_off_same_tokens_calls_and_one_reduction(mm, name):
    """Registry on or off: the same tokens and the same kernel-wrapper
    calls on every rank; on, each step reduces the layers' partials over
    the mesh once: an fp32 sum of (n_layers, 10) and a max of
    (n_layers, 2) (an all-reduce counts twice its bytes)."""
    res, _, _ = mm
    n_layers = get_config(GRANITE).smoke().n_layers
    for r in res[name]:
        for method in ("full", "quoka"):
            on, off = r[method, True], r[method, False]
            assert on["tokens"] == off["tokens"]
            assert on["calls"] == off["calls"]
            assert (on["calls"]["score"] > 0) == (method == "quoka")
            h = on["registry"]["hists"]
            steps = h["engine/prefill_step"][0] + h["engine/decode_step"][0]
            assert on["obs_bytes"] == {
                "all_reduce": steps * 2 * n_layers * 10 * 4,
                "all_reduce_max": steps * 2 * n_layers * 2 * 4}
            assert off["obs_bytes"] == {}
