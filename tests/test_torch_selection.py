"""The port's selection stages against the JAX reference (fp32, CPU).

Query subselection and scoring agree within 2e-5; plan indices must be
EQUAL, including under forced ties (``keep_first`` sinks are all +inf and
duplicated scores must break to the lower index, as ``jax.lax.top_k``
does); materialize at g=1 and g=16 gathers the same KV and positions.
Cross-layer plan reuse rebuilds on the reference's schedule, and a
4-layer granite-3-2b under reuse gives the reference's logits (1e-4) and
greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuokaConfig as RefQuokaConfig
from repro.core import plan as ref_plan
from repro.core import quoka as ref_quoka
from repro_torch.configs.base import QuokaConfig
from repro_torch.core import plan, quoka

torch.set_num_threads(2)

TOL = 2e-5


def _qcfgs(**kw):
    return RefQuokaConfig(**kw), QuokaConfig(**kw)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_kv", [2, 4])
def test_subselect_queries_matches_reference(n_kv, masked):
    rng = np.random.default_rng(10)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    q_valid = None
    if masked:
        q_valid = np.ones((2, 32), bool)
        q_valid[1, 20:] = False
    want = ref_quoka.subselect_queries(
        jnp.asarray(q), 8, n_kv=n_kv,
        q_valid=None if q_valid is None else jnp.asarray(q_valid))
    got = quoka.subselect_queries(
        torch.as_tensor(q), 8, n_kv=n_kv,
        q_valid=None if q_valid is None else torch.as_tensor(q_valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arm", [("cosine", "max"), ("dot", "max"),
                                 ("cosine", "mean")])
def test_quoka_scores_matches_reference(arm):
    scoring, agg = arm
    rcfg, pcfg = _qcfgs(scoring=scoring, query_agg=agg)
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 96, 2, 32)).astype(np.float32)
    valid = rng.random((2, 96)) < 0.7
    want = ref_quoka.quoka_scores(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(valid), rcfg)
    got = quoka.quoka_scores(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(valid), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("g", [1, 16])
def test_plan_from_scores_forced_ties_equal_ids(g):
    """Scores on a coarse lattice force many exact ties; sinks are stamped
    +inf; some slots are invalid (NEG_INF).  Plan ids must be identical."""
    rcfg, pcfg = _qcfgs(granularity=g, keep_first=4, budget=64)
    rng = np.random.default_rng(12)
    b, n_kv, T = 2, 2, 128
    scores = rng.integers(0, 3, (b, n_kv, T)).astype(np.float32)
    key_pos = np.arange(T, dtype=np.int32)[None].repeat(b, 0)
    key_pos[1, 100:] = -1
    scores[:, :, 90:] = -1e30
    want = ref_plan.plan_from_scores(jnp.asarray(scores), jnp.asarray(key_pos),
                                     rcfg)
    got = plan.plan_from_scores(torch.as_tensor(scores),
                                torch.as_tensor(key_pos), pcfg)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))


@pytest.mark.parametrize("g", [1, 16])
def test_build_and_materialize_match_reference(g):
    """Full stages 1-3 from queries and a partly-written cache, with a
    chunk start that straddles a 16-token block."""
    rcfg, pcfg = _qcfgs(granularity=g, budget=32, n_queries=4, keep_first=2)
    rng = np.random.default_rng(13)
    b, t, h, n_kv, T, d = 2, 16, 4, 2, 96, 16
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, T, n_kv, d)).astype(np.float32)
    v = rng.standard_normal((b, T, n_kv, d)).astype(np.float32)
    key_pos = np.arange(T, dtype=np.int32)[None].repeat(b, 0)
    key_pos[:, 70:] = -1
    start = 52
    q_valid = np.ones((b, t), bool)
    q_valid[0, :3] = False
    jargs = [jnp.asarray(x) for x in (q, k, v, key_pos)]
    targs = [torch.as_tensor(x) for x in (q, k, v, key_pos)]
    want = ref_plan.select("quoka", *jargs, jnp.int32(start), rcfg,
                           q_valid=jnp.asarray(q_valid))
    pln = plan.build("quoka", targs[0], targs[1], targs[3], start, pcfg,
                     q_valid=torch.as_tensor(q_valid))
    got = plan.materialize(pln, targs[1], targs[2], targs[3], start, pcfg)
    for name in ("pos", "idx", "k", "v"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


# ---------------------------------------------------------------------------
# cross-layer plan reuse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("corr", [(), (3,), (0, 5, 7)])
@pytest.mark.parametrize("interval", [1, 2, 4])
def test_refresh_decisions_match_reference(interval, corr):
    """Over layers 0-11 the port rebuilds exactly where the reference's
    ``_refresh_decision`` says so, and reuses the carried ids between."""
    rcfg, pcfg = _qcfgs(reuse_interval=interval, correction_layers=corr)
    shape = (1, 4)
    rcarry = ref_plan.empty_carry(shape)
    pcarry = plan.empty_carry(shape, "cpu")
    built = []
    for li in range(12):
        want = bool(ref_plan._refresh_decision(rcarry, li, rcfg))
        assert plan._refresh_decision(pcarry, li, pcfg) == want, li
        rcarry = ref_plan.PlanCarry(idx=rcarry.idx, valid=jnp.ones((), bool))
        pln, pcarry = plan.refresh(
            pcarry, li, pcfg,
            lambda: plan.SelectionPlan(idx=torch.full(shape, li)))
        assert pcarry.valid and torch.equal(pcarry.idx, pln.idx)
        built.append(int(pln.idx[0, 0]))
        if want:
            assert built[-1] == li
        else:
            assert built[-1] == built[-2]
    pln, carry = plan.refresh(None, 5, pcfg, lambda: plan.SelectionPlan(
        idx=torch.full(shape, 7)))
    assert carry is None and int(pln.idx[0, 0]) == 7


GRANITE_REUSE = {
    "interval2": {"reuse_interval": 2},
    "interval4": {"reuse_interval": 4},
    "interval4_corr1": {"reuse_interval": 4, "correction_layers": (1,)},
    "interval2_g16_fused": {"reuse_interval": 2, "granularity": 16,
                            "fused_select_attn": True},
}


def _granite_pair(qover):
    from repro.configs import get_config as ref_config
    from repro.models.model import build_model as ref_build
    from repro.training.checkpoint import _flatten
    from repro_torch.configs import get_config as port_config
    from repro_torch.training.checkpoint import from_flat
    rc = ref_config("granite-3-2b").smoke(n_layers=4)
    rc = dataclasses.replace(rc, quoka=dataclasses.replace(rc.quoka, **qover))
    pc = port_config("granite-3-2b").smoke(n_layers=4)
    pc = dataclasses.replace(pc, quoka=dataclasses.replace(pc.quoka, **qover))
    rm = ref_build(rc)
    params = rm.init(jax.random.PRNGKey(0))
    return rm, params, from_flat(_flatten(params), pc, "cpu")


def _granite_tokens():
    return np.random.default_rng(14).integers(3, 512, (2, 96)).astype(
        np.int32)


def _port_prefill(pm, toks):
    return pm.prefill({"tokens": toks}, pm.init_cache(2, 96), "quoka")[0]


@pytest.mark.parametrize("variant", sorted(GRANITE_REUSE))
def test_reuse_prefill_and_generate_match_reference(variant):
    """granite-3-2b smoke (4 layers) under plan reuse: prefill logits within
    1e-4 and greedy tokens equal to the reference; the carry changes the
    result (layers consume an earlier layer's plan)."""
    from repro.serving.engine import Engine as RefEngine
    from repro_torch.serving.engine import Engine
    rm, params, pm = _granite_pair(GRANITE_REUSE[variant])
    toks = _granite_tokens()
    want, _ = rm.prefill(params, {"tokens": jnp.asarray(toks)},
                         rm.init_cache(2, 96), "quoka")
    got = _port_prefill(pm, toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    no_reuse = dict(GRANITE_REUSE[variant], reuse_interval=1,
                    correction_layers=())
    base = _port_prefill(_granite_pair(no_reuse)[2], toks)
    assert not torch.allclose(got, base, atol=1e-6), "carry not engaged"
    rt = RefEngine(rm, params, method="quoka", backend="xla").generate(
        {"tokens": jnp.asarray(toks)}, 6).tokens
    pt = Engine(pm, method="quoka", device="cpu").generate(
        {"tokens": toks}, 6).tokens
    np.testing.assert_array_equal(pt, np.asarray(rt))


def test_corrections_everywhere_equal_interval_one():
    """reuse_interval 4 with every layer a correction layer rebuilds every
    layer: the same logits as interval 1."""
    toks = _granite_tokens()
    _, _, p1 = _granite_pair({"reuse_interval": 1})
    _, _, p4 = _granite_pair({"reuse_interval": 4,
                              "correction_layers": (0, 1, 2, 3)})
    np.testing.assert_allclose(_port_prefill(p4, toks).numpy(),
                               _port_prefill(p1, toks).numpy(), atol=1e-6,
                               rtol=1e-6)
