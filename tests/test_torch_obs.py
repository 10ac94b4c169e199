"""The port's serve-path telemetry (``repro_torch/obs``, ``LayerObs``,
``Engine`` / ``Scheduler(registry=)``, ``launch/serve.py --metrics``)
against the JAX reference's, on the CPU.

Both packages run the same weights: the reference's initial parameters go
through the weight bridge (``training/checkpoint.py::from_flat``), and the
inputs are numpy arrays from one seed.  Checked: the registry's
instruments and the same quantiles on the same streams; the three
exporters byte for byte on the same registry contents; the per-layer
``LayerObs`` of ``prefill_chunk`` / ``decode_step(with_obs=True)`` (counts
exact, the score sketch within 2e-5, NaN in the same places) on the smoke
configs of granite-3-2b (staged and fused g = 16, reuse interval 2),
deepseek-v3 (MLA), gemma3-27b (windowed layers), zamba2-7b (the shared
block beside mamba's NaN rows), rwkv6-1.6b (all NaN) and whisper-small
(``dec_cross``); a registry-on ``Engine.serve`` against the reference's
(counter names and values, gauges within 1e-6, histogram counts of the
metrics that are not times, ``stats``) on a prefix-hit trace and on an SLO
multi-tenant trace with a preemption; the host tier's counters against
the pool's own totals; metrics on and off giving the same tokens; and the
launcher's ``--metrics --trace-dir`` files.
"""
import dataclasses
import json
import re

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
from repro.training.checkpoint import _flatten
from repro_torch import obs
from repro_torch.configs import get_config as port_config
from repro_torch.core.plan import LayerObs
from repro_torch.launch import serve as serve_cli
from repro_torch.serving.engine import Engine
from repro_torch.serving.pool import blocks_for_request
from repro_torch.serving.request import make_requests
from repro_torch.training.checkpoint import from_flat

torch.set_num_threads(2)

BS = 16
SKETCH = ("score_lo", "score_mean", "score_hi")


def _pair(arch, qover=None):
    """(reference model, its params, the port's model with those weights)."""
    qover = qover or {}
    rc = ref_config(arch).smoke()
    rc = dataclasses.replace(rc, quoka=dataclasses.replace(rc.quoka, **qover))
    pc = port_config(arch).smoke()
    pc = dataclasses.replace(pc, quoka=dataclasses.replace(pc.quoka, **qover))
    rm = ref_build(rc)
    params = rm.init(jax.random.PRNGKey(0))
    return rm, params, from_flat(_flatten(params), pc, "cpu")


@pytest.fixture(scope="module")
def granite():
    return _pair("granite-3-2b")


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, (n,)).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_instruments_and_quantile_sanity():
    reg = obs.Registry()
    reg.count("a/n", 2)
    reg.count("a/n")
    assert reg.counters["a/n"].value == 3.0
    reg.set("g", 4.5)
    assert reg.gauges["g"].value == 4.5
    h = reg.histogram("h")
    for v in range(100):
        h.observe(float(v))
    s = h.summary()
    assert s["count"] == 100 and s["min"] == 0.0 and s["max"] == 99.0
    assert s["min"] <= s["p50"] <= s["p90"] <= s["p99"] <= s["max"]
    assert abs(s["mean"] - 49.5) < 1e-9
    assert reg.histogram("h") is h


@pytest.mark.parametrize("cap,n", [(64, 1000), (1024, 5000), (1024, 300)])
def test_same_stream_gives_the_references_quantiles(cap, n):
    """The algorithm-R reservoir keeps the reference's seeding, so a stream
    gives the same reservoir and quantiles in both packages, past the
    reservoir's size too; so do named instruments (seeded from the name's
    hash, one process)."""
    vals = np.random.default_rng(cap + n).standard_normal(n)
    mine, want = obs.Histogram(reservoir=cap, seed=3), \
        ref_obs.Histogram(reservoir=cap, seed=3)
    rm, rr = obs.Registry(), ref_obs.Registry()
    for v in vals:
        mine.observe(v)
        want.observe(v)
        rm.observe("select/kv_fraction", v)
        rr.observe("select/kv_fraction", v)
    assert mine._res == want._res and len(mine._res) == min(cap, n)
    assert mine.summary() == want.summary()
    assert rm.snapshot() == rr.snapshot()


def test_disabled_registry_records_nothing():
    reg = obs.Registry(enabled=False)
    reg.count("x")
    reg.set("y", 1.0)
    reg.observe("z", 2.0)
    with reg.span("s"):
        pass
    reg.event("e", k=1)
    assert not reg.counters and not reg.gauges and not reg.histograms
    assert not reg.events and not reg.trace_events
    assert obs.NULL.counter("a") is obs.NULL.counter("b")
    assert obs.NULL.span("s") is obs.NULL.span("t")


def test_span_times_into_histogram_and_trace():
    reg = obs.Registry()
    with reg.span("step", rows=3):
        torch.ones(4).sum()
    h = reg.histograms["step"]
    (ev,) = reg.trace_events
    assert h.count == 1 and h.sum > 0.0
    assert ev["name"] == "step" and ev["ph"] == "X" and ev["dur"] > 0.0
    assert ev["args"] == {"rows": 3}


def test_scope_prefixes_and_view_round_trips():
    reg = obs.Registry()
    sc = reg.scope("serve/prefix")
    sc.set("hits", 2)
    sc.count("reqs", 4)
    assert reg.gauges["serve/prefix/hits"].value == 2.0
    assert reg.view("serve/prefix") == {"hits": 2.0, "reqs": 4.0}
    assert sc.view() == reg.view("serve/prefix")
    assert sc.scope("x").counter("y") is reg.counter("serve/prefix/x/y")


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def _populate(reg):
    reg.count("sched/submitted", 3)
    reg.count("tenant/t0/finished")
    reg.set("select/layer00/kv_fraction", 0.25)
    reg.set("serve/prefix/hit_rate", float("nan"))
    reg.set("pool/host_blocks", float("inf"))
    for v in (0.01, 0.02, 0.03, 1e-7):
        reg.observe("engine/decode_step", v)
    reg.observe("0weird name-with.dots", -2.5)
    reg.event("serve_done", generated=12, method="quoka")
    reg.trace_events.append({"name": "engine/prefill_step", "ph": "X",
                             "pid": 1, "tid": 1, "ts": 12.5, "dur": 3.25,
                             "args": {"rows": 2}})
    return reg


def test_exports_match_the_reference_byte_for_byte(tmp_path):
    """The same registry contents render to identical JSONL, Prometheus
    and Chrome-trace text (the events' host times are copied across)."""
    mine, want = _populate(obs.Registry()), _populate(ref_obs.Registry())
    want.events = [dict(e) for e in mine.events]
    assert obs.jsonl_lines(mine) == ref_obs.jsonl_lines(want)
    assert obs.prometheus_text(mine) == ref_obs.prometheus_text(want)
    assert json.dumps(obs.chrome_trace(mine)) == \
        json.dumps(ref_obs.chrome_trace(want))
    got = obs.export_all(mine, str(tmp_path / "port"), prefix="t")
    ref = ref_obs.export_all(want, str(tmp_path / "ref"), prefix="t")
    assert sorted(got) == sorted(ref) == ["jsonl", "prometheus", "trace"]
    for kind in got:
        with open(got[kind], "rb") as a, open(ref[kind], "rb") as b:
            assert a.read() == b.read(), kind


def test_prometheus_export_format():
    txt = obs.prometheus_text(_populate(obs.Registry()))
    assert "select_layer00_kv_fraction 0.25" in txt
    assert 'engine_decode_step{quantile="0.5"}' in txt
    assert "engine_decode_step_count 4" in txt
    assert "serve_prefix_hit_rate NaN" in txt
    sample = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
                        r"(\{[a-zA-Z0-9_]+=\"[^\"]*\"\})? \S+$")
    for line in txt.splitlines():
        if line and not line.startswith("#"):
            assert sample.match(line), line


# ---------------------------------------------------------------------------
# per-layer LayerObs against the reference
# ---------------------------------------------------------------------------

OBS_CASES = {
    "granite_staged_reuse2": ("granite-3-2b", {"reuse_interval": 2}),
    "granite_fused_g16_reuse2": ("granite-3-2b", {
        "granularity": 16, "fused_select_attn": True, "reuse_interval": 2}),
    "deepseek_v3_mla": ("deepseek-v3-671b", {}),
    "gemma3_window": ("gemma3-27b", {}),
    "zamba2_shared_block": ("zamba2-7b", {}),
    "rwkv6_all_nan": ("rwkv6-1.6b", {}),
    "whisper_dec_cross": ("whisper-small", {}),
}


def _same_obs(got, want, what):
    assert isinstance(got, LayerObs), what
    for f in LayerObs._fields:
        g = getattr(got, f)
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        g, w = g.numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape, (what, f)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                      err_msg=f"{what} {f} NaN places")
        if f in SKETCH:
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-5,
                                       err_msg=f"{what} {f}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")


@pytest.mark.parametrize("case", sorted(OBS_CASES))
def test_layer_obs_match_reference(case):
    """Four prefill chunks (the last ragged on row 1) and two decode
    steps, batch 2, every call with ``with_obs=True`` (the reference's
    calls jitted): the port's ``LayerObs`` equal the reference's layer by
    layer, and its outputs equal those of the same calls with obs off."""
    arch, qover = OBS_CASES[case]
    rm, params, pm = _pair(arch, qover)
    b, t, cap = 2, pm.cfg.quoka.chunk_size, 6 * pm.cfg.quoka.chunk_size
    toks = np.random.default_rng(5).integers(
        3, pm.cfg.vocab, (b, 4 * t)).astype(np.int32)
    rc, pc, pc_off = rm.init_cache(b, cap), pm.init_cache(b, cap), \
        pm.init_cache(b, cap)
    ref_chunk = jax.jit(lambda p, tk, s, c, vl: rm.prefill_chunk(
        p, {"tokens": tk}, s, c, valid_len=vl, with_obs=True))
    ref_step = jax.jit(lambda p, tk, s, c: rm.decode_step(
        p, tk, s, c, with_obs=True))
    n_sel = 0
    for c in range(4):
        ch = toks[:, c * t:(c + 1) * t]
        vl = np.array([t, t - 6 if c == 3 else t], np.int32)
        _, rc, want = ref_chunk(params, jnp.asarray(ch), c * t, rc,
                                jnp.asarray(vl))
        last, pc, got = pm.prefill_chunk({"tokens": ch}, c * t, pc,
                                         valid_len=vl, with_obs=True)
        off, pc_off = pm.prefill_chunk({"tokens": ch}, c * t, pc_off,
                                       valid_len=vl)
        torch.testing.assert_close(last, off, rtol=0, atol=0)
        assert got.sel_tokens.shape == (pm.cfg.n_layers,)
        _same_obs(got, want, f"{case} chunk {c}")
        n_sel += int(np.isfinite(got.budget_tokens.numpy()).sum())
    tok = toks[:, -1]
    for i in range(2):
        rlg, rc, want = ref_step(params, jnp.asarray(tok), 4 * t + i, rc)
        lg, pc, got = pm.decode_step(torch.as_tensor(tok).long(), 4 * t + i,
                                     pc, with_obs=True)
        off, pc_off = pm.decode_step(torch.as_tensor(tok).long(), 4 * t + i,
                                     pc_off)
        torch.testing.assert_close(lg, off, rtol=0, atol=0)
        _same_obs(got, want, f"{case} decode {i}")
        n_sel += int(np.isfinite(got.budget_tokens.numpy()).sum())
        tok = np.asarray(rlg).argmax(-1).astype(np.int32)
    if case == "rwkv6_all_nan":
        assert n_sel == 0 and bool(torch.isnan(torch.stack(got)).all())
    else:
        assert n_sel > 0, f"{case}: no layer selected"
    if case == "zamba2_shared_block":
        assert bool(torch.isnan(torch.stack(got)[:, 0]).all())   # mamba
    if case.endswith("reuse2"):
        assert got.refreshed.tolist() == [1.0, 0.0]
        assert bool(torch.isnan(got.score_lo[1]))


# ---------------------------------------------------------------------------
# Engine / Scheduler with a registry, against the reference
# ---------------------------------------------------------------------------

TIME_HISTS = re.compile(r"(_s$|^engine/|^sched/(suspend|resume)$|"
                        r"^pool/h2d_stage$)")


def _same_registry(got, want):
    gc = {k: c.value for k, c in got.counters.items()}
    wc = {k: c.value for k, c in want.counters.items()}
    assert gc == wc
    assert sorted(got.gauges) == sorted(want.gauges)
    for k in want.gauges:
        g, w = got.gauges[k].value, want.gauges[k].value
        assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= 1e-6, k
    assert sorted(got.histograms) == sorted(want.histograms)
    for k, h in want.histograms.items():
        assert got.histograms[k].count == h.count, k
        if not TIME_HISTS.search(k):
            # not a time: the same samples, so the same summary
            for key, v in h.summary().items():
                assert got.histograms[k].summary()[key] == \
                    pytest.approx(v, rel=0, abs=1e-6), (k, key)


@pytest.mark.parametrize("method", ["full", "quoka"])
def test_registry_serve_matches_reference_with_prefix_hit(granite, method):
    """A cold then a warm (prefix-hit) serve over one state: the port's
    registry equals the reference's, its ``stats`` too, and the tokens
    equal the reference's and the port's own metrics-off serve."""
    rm, params, pm = granite
    rng = np.random.default_rng(7)
    sys_tok = rng.integers(3, pm.cfg.vocab, (48,)).astype(np.int32)
    prompts = [np.concatenate(
        [sys_tok, rng.integers(3, pm.cfg.vocab, (16,)).astype(np.int32)])
        for _ in range(3)]
    kw = dict(block_size=BS, max_decode_batch=4)

    def twice(eng, mk):
        st = eng.make_serve_state(mk(prompts, 5), **kw)
        return [eng.serve(mk(prompts, 5), state=st) for _ in range(2)]

    rreg, preg = ref_obs.Registry(), obs.Registry()
    ref_eng = RefEngine(rm, params, method=method, registry=rreg)
    want = twice(ref_eng, ref_requests)
    eng = Engine(pm, method=method, device="cpu", registry=preg)
    got = twice(eng, make_requests)
    off_eng = Engine(pm, method=method, device="cpu")
    off = twice(off_eng, make_requests)
    assert all(v > 0 for v in got[1].cached_len.values())
    for g, w, o in zip(got, want, off):
        for rid in w.tokens:
            np.testing.assert_array_equal(g.tokens[rid], w.tokens[rid])
            np.testing.assert_array_equal(o.tokens[rid], w.tokens[rid])
        assert g.prefix == w.prefix == o.prefix
    assert eng.stats == ref_eng.stats == off_eng.stats
    _same_registry(preg, rreg)
    assert preg.counters["sched/prefix_hit_requests"].value == 3
    if method == "quoka":
        layer_kv = [k for k in preg.gauges if k.endswith("/kv_fraction")]
        assert layer_kv
        for k in layer_kv:
            bud = preg.gauges[k.replace("kv_fraction", "budget_fraction")]
            assert preg.gauges[k].value <= bud.value + 1e-6
    (done,) = [e for e in preg.events if e["event"] == "serve_done"][-1:]
    assert done["generated"] == 15 and done["prefix_cache_hits"] == 3.0


def _slo_trace(mk, prompts):
    return mk(prompts, [10, 3, 3], tenants=["background", "interactive",
                                            "interactive"],
              priorities=[0, 1, 1], ttft_deadlines=[None, 1e9, 0.0])


def _serve_with_preemption(eng, mk, prompts):
    """SLO policy, two decode rows: the interactive requests (EDF first)
    and the background one run; once the background request has decoded
    three tokens it is suspended between steps (its blocks stay cached)
    and later resumed through a prefix match."""
    kw = dict(block_size=BS, max_decode_batch=2, policy="slo")
    state = eng.make_serve_state(_slo_trace(mk, prompts), **kw)
    stream = eng.serve_stream(_slo_trace(mk, prompts), state=state)
    forced = False
    while True:
        try:
            next(stream)
        except StopIteration as stop:
            res = stop.value
            break
        bg = [r for r in state.sched.decoding if r.tenant == "background"]
        if not forced and bg and len(bg[0].out) >= 3:
            state.sched.suspend(bg[0], state.now)
            forced = True
    return res


@pytest.mark.parametrize("method", ["full", "quoka"])
def test_registry_slo_multi_tenant_with_preemption_matches_reference(
        granite, method):
    """Tenant, deadline and preemption counters, the per-layer gauges and
    the non-time histogram counts equal the reference's; the ``sched/*``
    counters agree with the ``ServeResult`` fields."""
    rm, params, pm = granite
    prompts = _prompts(17, (40, 16, 20), pm.cfg.vocab)
    rreg, preg = ref_obs.Registry(), obs.Registry()
    want = _serve_with_preemption(
        RefEngine(rm, params, method=method, registry=rreg), ref_requests,
        prompts)
    got = _serve_with_preemption(
        Engine(pm, method=method, device="cpu", registry=preg),
        make_requests, prompts)
    off = _serve_with_preemption(Engine(pm, method=method, device="cpu"),
                                 make_requests, prompts)
    for rid in want.tokens:
        np.testing.assert_array_equal(got.tokens[rid], want.tokens[rid])
        np.testing.assert_array_equal(off.tokens[rid], want.tokens[rid])
    assert (got.preemptions, got.resumes, got.deadline_misses) == \
        (want.preemptions, want.resumes, want.deadline_misses) == (1, 1, 1)
    assert got.prefix == want.prefix
    _same_registry(preg, rreg)
    c = {k: v.value for k, v in preg.counters.items()}
    assert c["sched/preemptions"] == got.preemptions
    assert c["sched/resumes"] == got.resumes
    assert c["serve/deadline_miss"] == got.deadline_misses
    assert c["sched/submitted"] == c["sched/admitted"] == \
        c["sched/finished"] == len(got.tokens) == 3
    assert c["tenant/background/preemptions"] == 1
    assert c["tenant/interactive/deadline_met"] == 1
    assert preg.histograms["sched/suspend"].count == 1
    assert preg.histograms["sched/resume"].count == 1


def test_host_tier_counters_equal_the_pools_totals(granite):
    """With a host tier (the reference's host-tier tests are red here, so
    the port is held to its own pool): the ``pool/*`` tier counters and
    the ``serve/prefix`` tier gauges equal the pool's counts, and the
    tokens equal a metrics-off run's."""
    _, _, pm = granite
    x, y = _prompts(23, (2 * BS, 2 * BS), pm.cfg.vocab)
    need = blocks_for_request(2 * BS, 4, BS, BS)

    def run(reg):
        eng = Engine(pm, method="quoka", device="cpu", registry=reg)
        state = eng.make_serve_state(
            make_requests([x], 4), block_size=BS, num_blocks=need + 1,
            max_decode_batch=1, host_tier_blocks=4 * need, prefetch_depth=4)
        outs = [eng.serve(make_requests([p], 4), state=state)
                for p in (x, y, x)]
        return eng, state, outs

    reg = obs.Registry()
    eng, state, outs = run(reg)
    _, _, off = run(None)
    for a, b in zip(outs, off):
        np.testing.assert_array_equal(a.tokens[0], b.tokens[0])
    pool = state.pool
    assert pool.demoted > 0 and pool.promoted > 0
    c = {k: v.value for k, v in reg.counters.items()}
    for name in ("demoted", "promoted", "host_evictions", "staged_used"):
        assert c.get(f"pool/{name}", 0.0) == getattr(pool, name), name
    assert c.get("pool/staged", 0.0) >= pool.staged_used
    assert eng.stats["promoted"] == outs[2].prefix["promoted"] > 0
    assert reg.gauges["pool/host_blocks"].value >= 0.0
    assert c["sched/promoted_blocks"] == pool.promoted


def test_scheduler_registry_counts_lifecycle(granite):
    """``Scheduler(registry=)`` runs (it raised before): the lifecycle
    counters balance after a drain and the deadline counters split by
    tenant, as the reference's ``test_policy.py`` checks them."""
    _, _, pm = granite
    reg = obs.Registry()
    eng = Engine(pm, method="full", device="cpu", registry=reg)
    res = eng.serve(make_requests(_prompts(47, (16, 16), pm.cfg.vocab), 2,
                                  tenants=["t0", "t1"],
                                  ttft_deadlines=[0.0, 1e9]),
                    block_size=BS, max_decode_batch=2)
    assert res.deadline_misses == 1
    assert reg.counters["serve/deadline_miss"].value == 1
    assert reg.counters["tenant/t0/deadline_miss"].value == 1
    assert reg.counters["tenant/t1/deadline_met"].value == 1
    assert reg.gauges["sched/queue_depth"].value == 0.0
    assert reg.histograms["serve/ttft_s"].count == 2
    assert "deadline_miss" in reg.view("tenant/t0")


@pytest.mark.parametrize("qover", [
    {"reuse_interval": 2},
    {"reuse_interval": 2, "granularity": 16, "fused_select_attn": True}],
    ids=["staged", "fused"])
def test_registry_serve_makes_no_new_constants_once_warm(qover):
    """The telemetry constants (budgets, flags, NaN) are made once per
    value and device: a second registry-on serve of the same trace adds
    none.  The trace has dense-bypass, selecting and reusing layer calls,
    so every kind of ``LayerObs`` is built."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.models.model import build_model
    base = port_config("granite-3-2b").smoke()
    cfg = dataclasses.replace(base, quoka=dataclasses.replace(base.quoka,
                                                              **qover))
    pm = build_model(cfg, device="cpu", seed=0)
    prompts = _prompts(53, (80, 40), cfg.vocab)
    eng = Engine(pm, method="quoka", device="cpu", registry=obs.Registry())
    state = eng.make_serve_state(make_requests(prompts, 4), block_size=BS,
                                 max_decode_batch=2)
    eng.serve(make_requests(prompts, 4), state=state)
    n = len(plan_mod._CONST)
    eng.serve(make_requests(prompts, 4), state=state)
    assert eng.registry.counters["select/plan_reuse"].value > 0
    assert len(plan_mod._CONST) == n


def test_serve_launcher_metrics_and_trace_dir(tmp_path, capsys):
    out = tmp_path / "tel"
    serve_cli.main(["--device", "cpu", "--smoke", "--continuous",
                    "--metrics", "--trace-dir", str(out), "--prompt-len",
                    "64", "--n-requests", "4", "--max-new", "3"])
    text = capsys.readouterr().out
    assert "selected-KV fraction" in text and "engine/decode_step" in text
    recs = [json.loads(line) for line in
            (out / "serve_quoka.metrics.jsonl").read_text().splitlines()]
    assert recs[-1]["event"] == "snapshot"
    assert any(r["event"] == "serve_done" for r in recs)
    assert recs[-1]["counters"]["sched/finished"] == 4.0
    prom = (out / "serve_quoka.prom").read_text()
    assert "# TYPE select_kv_fraction summary" in prom
    trace = json.loads((out / "serve_quoka.trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"engine/prefill_step", "engine/decode_step"} <= names
    serve_cli.main(["--device", "cpu", "--smoke", "--prompt-len", "32",
                    "--batch", "1", "--max-new", "2", "--trace-dir",
                    str(out)])
    one = json.loads((out / "oneshot_quoka.trace.json").read_text())
    names = {e.get("name") for e in one["traceEvents"]}
    assert {"plan_scores", "ops_score_cpu", "ops_attention_cpu"} <= names
