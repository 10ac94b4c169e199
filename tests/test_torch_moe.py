"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
reference's (``repro/models/moe.py``) at smoke size, fp32 on the CPU.

The reference's initial expert weights are carried into the port's
``MoE`` module; inputs come from numpy with a seed.  Outputs and the
load-balance loss agree within 2e-5 (fp32, only summation order differs).
Capacity dispatch is checked where it drops pairs (capacity factor 0.5):
which (token, choice) pairs drop decides the output, so the port's set
must equal the one the reference's ids give, and N counts every token of
the batch (pad rows included).  A whole olmoe model with capacity dispatch
and a left-padded prompt gives the reference's greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import moe as ref_moe
from repro.models.model import build_model as ref_build
from repro.serving.engine import Engine as RefEngine
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config as port_config
from repro_torch.models import moe
from repro_torch.serving.engine import Engine
from repro_torch.training.checkpoint import from_flat

torch.set_num_threads(2)

TOL = 2e-5
KEY = jax.random.PRNGKey(0)


def _cfgs(arch="olmoe-1b-7b", **moe_over):
    rc, pc = ref_config(arch).smoke(), port_config(arch).smoke()
    return (dataclasses.replace(rc, moe=dataclasses.replace(rc.moe,
                                                            **moe_over)),
            dataclasses.replace(pc, moe=dataclasses.replace(pc.moe,
                                                            **moe_over)))


def _pair(arch="olmoe-1b-7b", **moe_over):
    """(ref cfg, ref params, port cfg, port MoE) with the same weights."""
    rc, pc = _cfgs(arch, **moe_over)
    p = ref_moe.moe_init(KEY, rc)
    pm = moe.MoE(pc, "cpu")
    with torch.no_grad():
        for key, arr in _flatten(p).items():
            name, _, sub = key.partition("/")
            dst = pm.shared[sub.split("/")[0]] if name == "shared" else \
                getattr(pm, name)
            dst.copy_(torch.from_numpy(np.array(arr)))
    return rc, p, pc, pm


def _x(seed, b, t, d, pad_rows=0):
    """(b, t, d) activations; the first ``pad_rows`` rows of batch row 0
    are zeros, as a padded slot's embedding may be anything."""
    x = np.random.default_rng(seed).standard_normal((b, t, d), np.float32)
    x[0, :pad_rows] = 0.0
    return x


def _dropped(ids, n_experts, cap):
    """(token, choice) pairs a fixed-capacity dispatch drops, ranked in
    token-major order, computed independently with numpy."""
    seen = np.zeros(n_experts, np.int64)
    out = set()
    for i, row in enumerate(np.asarray(ids)):
        for j, e in enumerate(row):
            if seen[e] >= cap:
                out.add((i, j))
            seen[e] += 1
    return out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
@pytest.mark.parametrize("dispatch,cf", [("dense", 1.25), ("capacity", 1.25),
                                         ("capacity", 0.5)])
def test_moe_apply_matches_reference(arch, dispatch, cf):
    """Both dispatches (deepseek adds the shared expert), with a batch whose
    pad rows count in N; at capacity factor 0.5 pairs drop and the dropped
    set is the reference's; the aux loss accumulates into ctx alike."""
    rc, p, pc, pm = _pair(arch, dispatch=dispatch, capacity_factor=cf)
    x = _x(3, 2, 24, rc.d_model, pad_rows=5)
    rctx, pctx = {"aux_loss": 0.5}, {"aux_loss": 0.5}
    want = ref_moe.moe_apply(p, jnp.asarray(x), rc, rctx)
    got = moe.moe_apply(pm, torch.as_tensor(x), pc, pctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(pctx["aux_loss"]),
                               float(rctx["aux_loss"]), rtol=1e-6)
    # the router's choices, and under capacity the dropped pairs
    xf = x.reshape(-1, rc.d_model)
    _, r_ids, _ = ref_moe._router(p, jnp.asarray(xf), rc.moe)
    _, ids, _ = moe.route(pm, torch.as_tensor(xf), pc.moe)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    if dispatch == "capacity":
        cap = moe.capacity(pc.moe, xf.shape[0])
        _, _, keep = moe.capacity_slots(ids, pc.moe.n_experts, cap)
        got_drop = {tuple(ix) for ix in np.argwhere(
            ~keep.numpy().reshape(ids.shape))}
        assert got_drop == _dropped(r_ids, rc.moe.n_experts, cap)
        assert got_drop or cf > 1                # 0.5 always drops


def test_capacity_counts_every_token_of_the_batch():
    """C = max(1, ceil(k * N / E * cf)) over all b * t tokens, as the
    reference computes it (one decode token at 256 experts still gets one
    slot)."""
    e = port_config("olmoe-1b-7b").moe
    assert moe.capacity(e, 128) == 20
    assert moe.capacity(e, 1) == 1
    ds = port_config("deepseek-v3-671b").moe
    assert moe.capacity(ds, 128) == 5
    assert moe.capacity(dataclasses.replace(ds, capacity_factor=0.5),
                        2 * 24) == 1


def test_capacity_matches_dense_at_high_capacity():
    """The port's capacity dispatch equals its dense dispatch when nothing
    is dropped (capacity factor E), mirroring the reference's own test."""
    _, _, pc, pm = _pair("olmoe-1b-7b", dispatch="dense")
    cap_cfg = dataclasses.replace(pc, moe=dataclasses.replace(
        pc.moe, dispatch="capacity",
        capacity_factor=float(pc.moe.n_experts)))
    x = torch.as_tensor(_x(4, 2, 16, pc.d_model))
    np.testing.assert_allclose(moe.moe_apply(pm, x, cap_cfg).numpy(),
                               moe.moe_apply(pm, x, pc).numpy(),
                               atol=2e-4, rtol=2e-4)


def test_aux_loss_only_with_ctx():
    """Inference passes no ctx and computes no aux loss; with a ctx the
    coefficient times the positive Switch loss is added."""
    _, _, pc, pm = _pair("olmoe-1b-7b")
    xf = torch.as_tensor(_x(5, 1, 16, pc.d_model)[0])
    assert moe.route(pm, xf, pc.moe)[2] is None
    ctx = {}
    moe.moe_apply(pm, xf[None], pc, ctx)
    assert float(ctx["aux_loss"]) > 0


@pytest.mark.parametrize("method", ["full", "quoka"])
def test_capacity_model_with_pad_slots_matches_reference(method):
    """olmoe smoke with capacity dispatch (cf 0.5, so pairs drop), batch
    2 with a left-padded prompt: the pad slots' tokens count in every
    chunk's N, and greedy tokens equal the reference's."""
    rc, pc = _cfgs(dispatch="capacity", capacity_factor=0.5)
    rm = ref_build(rc)
    params = rm.init(KEY)
    pm = from_flat(_flatten(params), pc, "cpu")
    toks = np.random.default_rng(6).integers(3, rc.vocab, (2, 57)) \
        .astype(np.int32)
    reng = RefEngine(rm, params, method=method, backend="xla")
    peng = Engine(pm, method=method, device="cpu")
    rb, pb = reng.pad_prompt(toks), peng.pad_prompt(toks)
    want = reng.generate({k: jnp.asarray(v) for k, v in rb.items()}, 8)
    got = peng.generate(pb, 8)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
