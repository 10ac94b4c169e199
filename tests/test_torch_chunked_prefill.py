"""The port's model-free chunked-prefill harness against the JAX reference
(CPU, fp32), mirroring ``tests/test_chunked_prefill.py``.

For every selection method, staged (g = 1) and fused (g = 16), the
harness's outputs, ``output_error``, ``key_recall`` and
``critical_key_recall`` agree with the reference's within 2e-5, on the
reference's own Figure-2 arrays (``repro.data.synthetic.structured_qkv``)
handed to both packages.  The reference runs once per case through
module-scope fixtures.  The port's own ``structured_qkv`` (a torch
generator, other numbers) is checked for its geometry.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import QuokaConfig as RefQuokaConfig
from repro.core import chunked_prefill as ref_cp
from repro.data.synthetic import structured_qkv as ref_structured_qkv
from repro.kernels import ops as ref_ops
from repro_torch.configs.base import QuokaConfig
from repro_torch.core import chunked_prefill as cp
from repro_torch.core.selection import METHODS
from repro_torch.data.synthetic import structured_qkv
from repro_torch.training.checkpoint import load_score_projection

torch.set_num_threads(2)

TOL = 2e-5
B, T, H, NKV, D = 2, 256, 4, 2, 32
SELECTING = [m for m in METHODS if m != "full"]
ROUTES = {"staged_g1": {}, "fused_g16": {"granularity": 16,
                                         "fused_select_attn": True}}
QCFG = dict(chunk_size=64, budget=96, n_queries=16, keep_first=4)


def _qcfgs(**kw):
    return RefQuokaConfig(**kw), QuokaConfig(**kw)


@pytest.fixture(scope="module")
def qkv():
    """The reference's Figure-2 arrays as (jax, torch) triples."""
    load_score_projection(D, D, np.asarray(ref_ops.score_projection(D, D)))
    jq, jk, jv = ref_structured_qkv(jax.random.PRNGKey(3), B, T, H, NKV, D)
    return (jq, jk, jv), tuple(torch.as_tensor(np.array(x))
                               for x in (jq, jk, jv))


@pytest.fixture(scope="module")
def ref_dense(qkv):
    return np.asarray(ref_cp.dense_causal_reference(*qkv[0]))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_dense_reference_matches(qkv, ref_dense):
    got = cp.dense_causal_reference(*qkv[1])
    _close(got.numpy(), ref_dense)
    rcfg, pcfg = _qcfgs(**QCFG)
    _close(cp.chunked_sparse_attention(*qkv[1], pcfg, "full").numpy(),
           ref_dense)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("method", SELECTING)
def test_harness_matches_reference(qkv, ref_dense, method, route):
    rcfg, pcfg = _qcfgs(**QCFG, **ROUTES[route])
    (jq, jk, jv), (tq, tk, tv) = qkv
    want = np.asarray(ref_cp.chunked_sparse_attention(jq, jk, jv, rcfg,
                                                      method))
    got = cp.chunked_sparse_attention(tq, tk, tv, pcfg, method)
    assert got.shape == (B, T, H, D)
    _close(got.numpy(), want)
    # output_error: the reference's definition on its own arrays
    err_want = np.linalg.norm(want - ref_dense) / (
        np.linalg.norm(ref_dense) + 1e-9)
    err = float(cp.output_error(tq, tk, tv, pcfg, method))
    assert err == pytest.approx(float(err_want), abs=TOL, rel=TOL)
    assert 0.0 < err < 1.0
    for fn in ("key_recall", "critical_key_recall"):
        w = float(getattr(ref_cp, fn)(jq, jk, jv, rcfg, method))
        g = float(getattr(cp, fn)(tq, tk, tv, pcfg, method))
        assert g == pytest.approx(w, abs=TOL), fn
    w = float(ref_cp.key_recall(jq, jk, jv, rcfg, method, oracle="mean"))
    g = float(cp.key_recall(tq, tk, tv, pcfg, method, oracle="mean"))
    assert g == pytest.approx(w, abs=TOL)


def test_output_error_calls_match_reference(qkv):
    """``output_error`` itself (not only its formula) on both sides."""
    rcfg, pcfg = _qcfgs(**QCFG)
    want = float(ref_cp.output_error(*qkv[0], rcfg, "quoka"))
    assert float(cp.output_error(*qkv[1], pcfg, "quoka")) == \
        pytest.approx(want, abs=TOL, rel=TOL)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_full_budget_is_exact(qkv, ref_dense, route):
    """budget >= T: every prior key is selected, so the harness is dense
    causal attention."""
    _, pcfg = _qcfgs(chunk_size=64, budget=T, n_queries=16, **ROUTES[route])
    got = cp.chunked_sparse_attention(*qkv[1], pcfg, "quoka")
    np.testing.assert_allclose(got.numpy(), ref_dense, atol=2e-5, rtol=1e-4)


def test_causality_future_tokens_do_not_change_past(qkv):
    _, pcfg = _qcfgs(chunk_size=64, budget=96, n_queries=8)
    q, k, v = qkv[1]
    out1 = cp.chunked_sparse_attention(q, k, v, pcfg, "quoka")
    gen = torch.Generator().manual_seed(9)
    q2, k2 = q.clone(), k.clone()
    q2[:, -64:] = torch.randn((B, 64, H, D), generator=gen)
    k2[:, -64:] = torch.randn((B, 64, NKV, D), generator=gen)
    out2 = cp.chunked_sparse_attention(q2, k2, v, pcfg, "quoka")
    np.testing.assert_allclose(out1[:, :-64].numpy(), out2[:, :-64].numpy(),
                               atol=2e-5, rtol=1e-4)


def test_ragged_length_raises(qkv):
    _, pcfg = _qcfgs(chunk_size=96)
    with pytest.raises(ValueError, match="multiple"):
        cp.chunked_sparse_attention(*qkv[1], pcfg, "quoka")


# ---------------------------------------------------------------------------
# the port's own generator: the geometry, not the numbers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_qkv():
    return structured_qkv(3, 2, 512, 8, 2, 32)


def test_structured_qkv_geometry(port_qkv):
    q, k, v = port_qkv
    assert q.shape == (2, 512, 8, 32) and k.shape == v.shape == \
        (2, 512, 2, 32)
    t = 512
    needles = np.linspace(7, t - 8, 24).astype(np.int64)
    mq = q.mean((0, 1, 2))
    cos_q = torch.nn.functional.cosine_similarity(q, mq.expand_as(q), dim=-1)
    outlier = cos_q.mean(2) < 0.5                          # (b, t) per token
    share = float(outlier.float().mean())
    assert 0.05 < share < 0.11, share                      # outlier_frac 0.08
    # outliers are token-level: every head of a token agrees
    assert bool(((cos_q < 0.5) == outlier[..., None]).all())
    # sinks: the first 4 keys align with the bulk query and are large
    cos_k = torch.nn.functional.cosine_similarity(k, mq.expand_as(k), dim=-1)
    assert bool((cos_k[:, :4] > 0.9).all())
    assert bool((k[:, :4].norm(dim=-1) > 12).all())
    # the key cluster points away from the mean query (1.5 dk against
    # noise of norm 0.5 sqrt(d): cosine about -0.47 at d = 32)
    bulk = torch.ones(t, dtype=torch.bool)
    bulk[:4] = False
    bulk[needles] = False
    assert float(cos_k[:, bulk].mean()) < -0.3
    # needles: distinct directions at the fixed positions, values x3
    kn = k[:, needles].norm(dim=-1)
    assert bool(((kn > 3) & (kn < 5)).all())
    assert float(v[:, needles].std()) > 2 * float(v[:, bulk].std())
    # each outlier query points at a needle key
    b_i, t_i = torch.nonzero(outlier, as_tuple=True)
    qo = q[b_i, t_i].mean(1)                               # (n, d)
    kneed = k[:, needles].mean(2)[b_i]                     # (n, 24, d)
    best = torch.nn.functional.cosine_similarity(qo[:, None], kneed,
                                                 dim=-1).amax(-1)
    assert float(best.mean()) > 0.8


def test_structured_qkv_is_seeded_and_on_the_device(port_qkv):
    again = structured_qkv(3, 2, 512, 8, 2, 32, device="cpu")
    for a, b in zip(port_qkv, again):
        assert torch.equal(a, b)
    assert not torch.equal(structured_qkv(4, 2, 512, 8, 2, 32)[0],
                           port_qkv[0])


def test_quoka_beats_sample_attention_on_port_geometry(port_qkv):
    """The reference test's claim on the port's own arrays: QUOKA's
    max-oracle recall and output error beat SampleAttention's."""
    _, pcfg = _qcfgs(chunk_size=128, budget=64, n_queries=16, keep_first=4)
    r_q = float(cp.key_recall(*port_qkv, pcfg, "quoka"))
    r_s = float(cp.key_recall(*port_qkv, pcfg, "sample_attention"))
    e_q = float(cp.output_error(*port_qkv, pcfg, "quoka"))
    e_s = float(cp.output_error(*port_qkv, pcfg, "sample_attention"))
    assert r_q > r_s, (r_q, r_s)
    assert e_q < e_s, (e_q, e_s)


def test_error_decreases_with_budget(port_qkv):
    errs = []
    for budget in (32, 64, 128, 383):
        _, pcfg = _qcfgs(chunk_size=128, budget=budget, n_queries=16,
                         keep_first=4)
        errs.append(float(cp.output_error(*port_qkv, pcfg, "quoka")))
    assert errs[-1] <= errs[0]
    assert errs[-1] < 0.1


def test_dataclass_fields_match_reference():
    """Every QuokaConfig field the harness reads exists with the
    reference's default."""
    ref = {f.name: f.default for f in dataclasses.fields(RefQuokaConfig)}
    for f in dataclasses.fields(QuokaConfig):
        assert f.name in ref and ref[f.name] == f.default, f.name
