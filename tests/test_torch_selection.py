"""The port's selection stages against the JAX reference (fp32, CPU).

Query subselection and scoring agree within 2e-5; plan indices must be
EQUAL, including under forced ties (``keep_first`` sinks are all +inf and
duplicated scores must break to the lower index, as ``jax.lax.top_k``
does); materialize at g=1 and g=16 gathers the same KV and positions.
"""
import dataclasses

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


def test_reuse_interval_not_yet_ported():
    pcfg = dataclasses.replace(QuokaConfig(), reuse_interval=2)
    z = torch.zeros((1, 4, 2, 64))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        plan.select_with_ctx("quoka", z, z, z, torch.zeros((1, 4),
                             dtype=torch.int32), 0, pcfg)
