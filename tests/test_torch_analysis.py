"""The port's analysis tools on the CPU: the roofline (``model_flops``
against the reference's for every config, the three terms and the
bottleneck at the H100's data-sheet peaks) and the profiler scope query
(``analysis/trace_ops.py``, the port's form of ``analysis/hlo.py``'s
``gathers_in_scope``): the fused serve route runs no gather or index op
under ``plan_materialize`` and the staged route does, and every named
range — a registry span, ``plan_scores``, ``plan_materialize`` and the
facade's ``ops_*`` — shows in a trace with CPU activity only."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.analysis import roofline as ref_roofline
from repro.configs import get_config as ref_config
from repro.configs import list_configs
from repro_torch.analysis import roofline, trace_ops
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.obs import Registry
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import make_requests

torch.set_num_threads(2)

ARCHS = sorted(list_configs())


def test_every_config_is_covered():
    assert len(ARCHS) == 12


@pytest.mark.parametrize("shape", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch, shape):
    pc, rc = get_config(arch), ref_config(arch)
    for batch, seq, budget in ((1, 8192, None), (8, 4096, 1024),
                               (128, 32768, None)):
        got = roofline.model_flops(pc, shape, batch, seq, budget)
        want = ref_roofline.model_flops(rc, shape, batch, seq, budget)
        assert got == pytest.approx(want, rel=1e-12, abs=0), (batch, seq)
    with pytest.raises(ValueError):
        roofline.model_flops(pc, "bogus", 1, 1)


def test_roofline_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    from repro_torch.launch import train
    assert train.BF16_PEAK_FLOP_S == roofline.PEAK_FLOPS


@pytest.mark.parametrize("scale,bottleneck", [
    ((1.0, 0.5, 0.25), "compute"), ((0.5, 2.0, 0.25), "memory"),
    ((0.1, 0.2, 3.0), "collective")])
def test_roofline_terms_and_bottleneck(scale, bottleneck):
    c, m, x = scale
    r = roofline.analyse(
        "qwen3-4b", "prefill", "1", 1,
        {"flops": c * roofline.PEAK_FLOPS, "bytes": m * roofline.HBM_BW},
        {"coll_total": x * roofline.LINK_BW}, model_flops=2e15, note="n")
    assert (r.t_compute, r.t_memory, r.t_collective) == \
        pytest.approx((c, m, x), rel=1e-12)
    assert r.bottleneck == bottleneck
    assert r.useful_ratio == pytest.approx(2e15 / (c * roofline.PEAK_FLOPS))
    d = r.as_dict()
    assert d["hlo_flops"] == c * roofline.PEAK_FLOPS and d["note"] == "n"
    r4 = roofline.analyse("a", "s", "4", 4, {"flops": 1e12,
                                             "bytes accessed": 1e9},
                          {"total": 0.0}, model_flops=4e12)
    assert r4.hlo_bytes == 1e9 and r4.useful_ratio == pytest.approx(1.0)


def _engine(fused, registry=None):
    cfg = get_config("granite-3-2b").smoke()
    qover = {"granularity": 16, "fused_select_attn": True} if fused else {}
    cfg = dataclasses.replace(cfg, quoka=dataclasses.replace(cfg.quoka,
                                                             **qover))
    return Engine(build_model(cfg, device="cpu"), method="quoka",
                  device="cpu", registry=registry)


def _profiled_serve(eng, prompts):
    reqs = make_requests(prompts, 3)
    state = eng.make_serve_state(reqs, block_size=16, max_decode_batch=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = eng.serve(reqs, state=state)
    return prof, res


def test_fused_serve_step_has_no_materialize_gather():
    """The staged serve step runs gathers inside ``plan_materialize``
    (proving the range is recorded), the fused step none, and greedy
    tokens agree.  Prompts exceed budget + chunk (48 tokens), so both
    routes select."""
    prompts = [np.arange(1, 90, dtype=np.int32),
               np.arange(7, 60, dtype=np.int32)]
    got = {}
    for fused in (False, True):
        prof, res = _profiled_serve(_engine(fused), prompts)
        got[fused] = (trace_ops.gathers_in_scope(prof, "plan_materialize"),
                      trace_ops.ops_in_scope(prof, "plan_scores"), res)
    assert got[False][0], "staged step lost the plan_materialize range " \
                          "— the fused == [] assertion would be vacuous"
    assert got[True][0] == []
    assert got[True][1] and got[False][1]          # both routes scored
    for rid, toks in got[False][2].tokens.items():
        assert len(toks) == len(got[True][2].tokens[rid]) == 3


@pytest.mark.parametrize("fused", [False, True])
def test_named_ranges_show_in_a_cpu_trace(fused):
    """With CPU activity only: the registry's spans (``engine/*``), the
    plan's stages and the facade's ``ops_*_cpu`` ranges are recorded, each
    with the aten ops it ran under it."""
    prompts = [np.arange(1, 90, dtype=np.int32)]
    prof, _ = _profiled_serve(_engine(fused, Registry()), prompts)
    names = trace_ops.range_names(prof)
    attn = "ops_selected_attention_cpu" if fused else "ops_attention_cpu"
    want = {"engine/prefill_step", "engine/decode_step", "plan_scores",
            "ops_score_cpu", attn, "pool_gather", "pool_scatter"}
    if not fused:
        want.add("plan_materialize")
    assert want <= names, want - names
    for name in want:
        assert any(op.startswith("aten::")
                   for op in trace_ops.ops_in_scope(prof, name)), name
    step_ops = trace_ops.ops_in_scope(prof, "engine/prefill_step")
    assert "plan_scores" in step_ops and attn in step_ops
