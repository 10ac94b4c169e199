"""The port's six baseline selectors and low-rank scoring against the JAX
reference (CPU), and every selection method through the port's engine.

Inputs are drawn with numpy from a seed and handed to both packages.  The
low-rank projection is the reference's own array, installed in the port
through ``training/checkpoint.py::load_score_projection`` (the reference
draws it from ``jax.random``).  Tolerances: scores atol = rtol = 1e-5 with
fp32 K, 1e-4 with bf16 K (both sides cast K to fp32, so only summation
order differs); plan ids and greedy tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.base import QuokaConfig as RefQuokaConfig
from repro.core import plan as ref_plan
from repro.core import quoka as ref_quoka
from repro.core import selection as ref_sel
from repro.kernels import ops as ref_ops
from repro.models.model import build_model as ref_build
from repro.serving.engine import Engine as RefEngine
from repro.serving.request import make_requests as ref_requests
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import QuokaConfig
from repro_torch.core import plan, quoka, selection
from repro_torch.kernels import ops
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import make_requests
from repro_torch.training.checkpoint import from_flat, load_score_projection

torch.set_num_threads(2)

BASELINES = [m for m in selection.METHODS if m not in ("quoka", "full")]
TOL = {"float32": 1e-5, "bfloat16": 1e-4}


def _load_projection(d, r):
    """Give the port the reference's cached (d, r) projection."""
    load_score_projection(d, r, np.asarray(ref_ops.score_projection(d, r)))


def _qcfgs(**kw):
    return RefQuokaConfig(**kw), QuokaConfig(**kw)


def _inputs(t, dtype, seed=0, b=3, h=4, n_kv=2, T=80, d=32):
    """q (b, t, h, d), k (b, T, n_kv, d) in ``dtype`` as (jax, torch) pairs,
    and validity: row 0 partly valid, row 1 all invalid, row 2 all valid."""
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.standard_normal((b, t, h, d), np.float32))
    k = torch.as_tensor(rng.standard_normal((b, T, n_kv, d), np.float32))
    q, k = q.to(getattr(torch, dtype)), k.to(getattr(torch, dtype))
    valid = np.ones((b, T), bool)
    valid[0] = rng.random(T) < 0.6
    valid[1] = False

    def jx(x):
        return jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype))
    return (jx(q), q), (jx(k), k), (jnp.asarray(valid),
                                    torch.as_tensor(valid))


def test_methods_are_the_reference_methods():
    assert selection.METHODS == ref_sel.METHODS


@pytest.mark.parametrize("t", [5, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", BASELINES)
def test_baseline_scores_and_plan_match_reference(method, dtype, t):
    """t = 5 is shorter than N_Q = 16 (every query is sampled / in the
    window); row 1 has no valid slot, so its plan is all padding."""
    rcfg, pcfg = _qcfgs(rank=16, budget=24, keep_first=2)
    _load_projection(32, 16)
    (jq, tq), (jk, tk), (jv, tv) = _inputs(t, dtype)
    want = ref_sel.compute_scores(method, jq, jk, jv, rcfg)
    got = selection.compute_scores(method, tq, tk, tv, pcfg)
    assert got.dtype == torch.float32
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
    key_pos = np.arange(80, dtype=np.int32)[None].repeat(3, 0)
    rp = ref_plan.plan_from_scores(want, jnp.asarray(key_pos), rcfg)
    pp = plan.plan_from_scores(got, torch.as_tensor(key_pos), pcfg)
    np.testing.assert_array_equal(pp.idx.numpy(), np.asarray(rp.idx))
    assert (pp.idx[1] == -1).all()


@pytest.mark.parametrize("n", range(1, 33))
def test_sample_positions_equal_reference(n):
    """The sampled query rows equal ``jnp.linspace(0, t-1, n).astype(int32)``
    for every t in 1..1024 (a float64 linspace misses some boundaries)."""
    for t in range(1, 1025):
        want = np.asarray(jnp.linspace(0, t - 1, n).astype(jnp.int32))
        np.testing.assert_array_equal(
            selection.sample_positions(t, n).numpy(), want,
            err_msg=f"t={t}")


def test_sparq_channel_ties_keep_lower_index():
    """Channels with equal mean |q̄| tie; ``lax.top_k`` keeps the lower
    channel, and so must the port (it changes the scores)."""
    rcfg, pcfg = _qcfgs(rank=4)
    rng = np.random.default_rng(3)
    b, t, h, n_kv, T, d = 2, 6, 4, 2, 40, 16
    # |q| is 1 or 2 per channel with random signs: the group means of |q|
    # coincide on many channels
    mag = np.where(np.arange(d) % 3 == 0, 2.0, 1.0).astype(np.float32)
    sign = np.sign(rng.standard_normal((b, t, 1, d))).astype(np.float32)
    q = np.broadcast_to(mag * sign, (b, t, h, d)).copy()
    k = rng.standard_normal((b, T, n_kv, d)).astype(np.float32)
    valid = np.ones((b, T), bool)
    want = ref_sel.sparq_scores(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(valid), rcfg)
    got = selection.sparq_scores(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(valid), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the tie-break matters: ties to the HIGHER channel give other scores
    qg = torch.as_tensor(q).reshape(b, t, n_kv, h // n_kv, d).mean(3)
    hi = (d - 1) - quoka.topk_stable(qg.abs().mean(1).flip(-1), 4)[1]
    qc = torch.gather(qg.transpose(1, 2), 3,
                      hi[:, :, None, :].expand(-1, -1, t, -1))
    kc = torch.gather(torch.as_tensor(k).transpose(1, 2), 3,
                      hi[:, :, None, :].expand(-1, -1, T, -1))
    alt = torch.einsum("bktr,bksr->bkts", qc, kc).mean(2)
    assert not np.allclose(alt.numpy(), np.asarray(want), atol=1e-3)


def test_snapkv_pool_ends_match_reference():
    """The first and last three keys take the pool's padding."""
    rcfg, pcfg = _qcfgs()
    (jq, tq), (jk, tk), (jv, tv) = _inputs(24, "float32", seed=4)
    want = np.asarray(ref_sel.snapkv_scores(jq, jk, jv, rcfg))
    got = selection.snapkv_scores(tq, tk, tv, pcfg).numpy()
    for sl in (slice(0, 3), slice(-3, None)):
        np.testing.assert_allclose(got[..., sl], want[..., sl], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_with_projection_matches_reference(dtype):
    """``ops.score(proj=)``: q̄ projected in fp32, K in its storage dtype,
    then the scoring kernel's plain version at head dim r."""
    _load_projection(64, 32)
    rng = np.random.default_rng(5)
    qb = rng.standard_normal((2, 5, 2, 64)).astype(np.float32)
    qb /= np.linalg.norm(qb, axis=-1, keepdims=True)
    k = torch.as_tensor(rng.standard_normal((2, 90, 2, 64), np.float32))
    k = k.to(getattr(torch, dtype))
    valid = rng.random((2, 90)) < 0.8
    jk = jnp.asarray(k.float().numpy()).astype(getattr(jnp, dtype))
    want = ref_ops.score(jnp.asarray(qb), jk, jnp.asarray(valid),
                         backend="xla",
                         proj=ref_ops.score_projection(64, 32))
    got = ops.score(torch.as_tensor(qb), k, torch.as_tensor(valid),
                    proj=ops.score_projection(64, 32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quoka_low_rank_scores_match_reference(dtype):
    """``score_proj_dim = 32`` at d = 64 through ``quoka_scores``, and the
    plan built from them."""
    _load_projection(64, 32)
    rcfg, pcfg = _qcfgs(score_proj_dim=32, budget=24)
    (jq, tq), (jk, tk), (jv, tv) = _inputs(24, dtype, seed=6, d=64)
    jqs = ref_quoka.subselect_queries(jq, 16, n_kv=2)
    tqs = quoka.subselect_queries(tq, 16, n_kv=2)
    want = ref_quoka.quoka_scores(jqs, jk, jv, rcfg)
    got = quoka.quoka_scores(tqs, tk, tv, pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL[dtype], rtol=TOL[dtype])
    key_pos = np.arange(80, dtype=np.int32)[None].repeat(3, 0)
    rp = ref_plan.plan_from_scores(want, jnp.asarray(key_pos), rcfg)
    pp = plan.plan_from_scores(got, torch.as_tensor(key_pos), pcfg)
    np.testing.assert_array_equal(pp.idx.numpy(), np.asarray(rp.idx))
    # the projection is really used: full-dim scores differ
    full = quoka.quoka_scores(tqs, tk, tv, QuokaConfig())
    assert not torch.allclose(full[0], got[0], atol=1e-3)


def test_projection_is_seeded_and_shared_across_calls():
    """Without the bridge the port draws its own projection from a
    generator seeded 7: the same array on every call, scaled 1/sqrt(r)."""
    a = ops.score_projection(48, 16)
    assert a is ops.score_projection(48, 16)
    gen = torch.Generator().manual_seed(7)
    np.testing.assert_array_equal(
        a.numpy(), (torch.randn((48, 16), generator=gen) / 4.0).numpy())
    with pytest.raises(ValueError, match="shape"):
        load_score_projection(48, 16, np.zeros((16, 48), np.float32))


# ---------------------------------------------------------------------------
# every method on the model
# ---------------------------------------------------------------------------

PROMPT, MAX_NEW = 64, 8            # 64 + 8 > budget 32 + chunk 16


def _pair(arch, qover=None):
    qover = qover or {}
    rc = ref_config(arch).smoke()
    rc = dataclasses.replace(rc, quoka=dataclasses.replace(rc.quoka, **qover))
    pc = port_config(arch).smoke()
    pc = dataclasses.replace(pc, quoka=dataclasses.replace(pc.quoka, **qover))
    rm = ref_build(rc)
    params = rm.init(jax.random.PRNGKey(0))
    return rm, params, from_flat(_flatten(params), pc, "cpu")


@pytest.fixture(scope="module")
def qwen():
    _load_projection(64, 64)           # loki at the smoke head dim
    _load_projection(64, 32)           # score_proj_dim = 32
    return _pair("qwen3-4b")


@pytest.fixture(scope="module")
def prompt_tokens():
    return np.random.default_rng(11).integers(3, 512, (2, PROMPT)).astype(
        np.int32)


@pytest.mark.parametrize("method", selection.METHODS)
def test_generate_tokens_match_reference(qwen, prompt_tokens, method):
    rm, params, pm = qwen
    want = RefEngine(rm, params, method=method, backend="xla").generate(
        {"tokens": jnp.asarray(prompt_tokens)}, MAX_NEW).tokens
    got = Engine(pm, method=method, device="cpu").generate(
        {"tokens": prompt_tokens}, MAX_NEW).tokens
    np.testing.assert_array_equal(got, np.asarray(want))


def test_low_rank_generate_tokens_match_reference(prompt_tokens):
    _load_projection(64, 32)
    rm, params, pm = _pair("qwen3-4b", {"score_proj_dim": 32})
    want = RefEngine(rm, params, method="quoka", backend="xla").generate(
        {"tokens": jnp.asarray(prompt_tokens)}, MAX_NEW).tokens
    got = Engine(pm, method="quoka", device="cpu").generate(
        {"tokens": prompt_tokens}, MAX_NEW).tokens
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("method,qover", [
    pytest.param("snapkv", None, id="snapkv"),
    pytest.param("sparq", None, id="sparq"),
    pytest.param("quoka", {"reuse_interval": 4}, id="quoka-reuse4"),
    pytest.param("quoka", {"score_proj_dim": 32}, id="quoka-proj32")])
def test_serve_tokens_match_reference(qwen, method, qover):
    """Two baselines, and plan reuse and low-rank scoring on the serve
    step (the carry is built on the step's gathered view, a start per
    row)."""
    rm, params, pm = _pair("qwen3-4b", qover) if qover else qwen
    rng = np.random.default_rng(12)
    prompts = [rng.integers(3, 512, (n,)).astype(np.int32)
               for n in (64, 48, 16)]
    kw = dict(block_size=16, max_decode_batch=3, max_prefill_tokens=32)
    want = RefEngine(rm, params, method=method).serve(
        ref_requests(prompts, 6), **kw)
    got = Engine(pm, method=method, device="cpu").serve(
        make_requests(prompts, 6), **kw)
    assert sorted(got.tokens) == sorted(want.tokens)
    for rid in want.tokens:
        np.testing.assert_array_equal(got.tokens[rid],
                                      np.asarray(want.tokens[rid]))


def test_unknown_method_raises_like_reference(qwen):
    _, _, pm = qwen
    with pytest.raises(ValueError, match="unknown selection method"):
        Engine(pm, method="h2o", device="cpu")
    with pytest.raises(ValueError, match="unknown selection method"):
        selection.compute_scores("h2o", None, torch.zeros((1, 4, 1, 16)),
                                 None, QuokaConfig())
