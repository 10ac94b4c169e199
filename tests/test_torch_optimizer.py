"""AdamW in the port (``training/optimizer.py``) against the JAX reference
on the CPU, fp32.

Checked: ``schedule`` and ``global_norm`` (with clipping) equal the
reference's within 1e-6 relative; ``apply_updates`` gives the reference's
parameters and moments, three steps running, within 1e-6 of each leaf's
largest magnitude on the same parameters (the reference's
``model.init(PRNGKey(0))`` through the weight bridge), the same gradients
and the same state, for granite-3-2b, zamba2-7b, whisper-small and
deepseek-v3 at smoke size; the decay mask equals the reference's on
their flat keys, stacked norm gains and Mamba2 scalars decayed and the
top-level gains not (the reference decides on the rank of its leaf,
which a stack raises by one); and the reference's five optimizer tests
(``tests/test_training.py``) hold for the port.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.model import build_model as ref_build
from repro.training import optimizer as ref_opt
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config as port_config
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt

torch.set_num_threads(2)

ARCHS = ["granite-3-2b", "zamba2-7b", "whisper-small", "deepseek-v3-671b"]


def _tree(template, flat):
    """The reference's pytree ``template`` with leaves from ``flat``
    (its '/'-joined keys, as ``_flatten`` makes them)."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    keys = list(_flatten(template))
    assert len(keys) == len(paths)
    return treedef.unflatten([jnp.asarray(flat[k]) for k in keys])


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's smoke parameters (immutable arrays, drawn once)."""
    return ref_build(ref_config(arch).smoke()).init(jax.random.PRNGKey(0))


def _pair(arch):
    params = _ref_params(arch)
    return params, ckpt.from_flat(_flatten(params), port_config(arch).smoke(),
                                  "cpu")


def _per_param(model, flat):
    """``flat`` (reference keys) as a list in ``model.parameters()``
    order, each row of a stacked leaf to its layer."""
    index = {p: i for i, p in enumerate(model.parameters())}
    out = [None] * len(index)
    for key, (ts, stacked) in ckpt.leaf_map(model).items():
        for t, row in zip(ts, flat[key] if stacked else [flat[key]]):
            out[index[t]] = torch.as_tensor(np.array(row))
    return out


def test_schedule_matches_reference():
    for cfg in (dict(lr=1e-3, warmup_steps=10, total_steps=100),
                dict(lr=3e-4, warmup_steps=1, total_steps=3),
                dict(lr=3e-3, warmup_steps=0, total_steps=50,
                     min_lr_ratio=0.3)):
        rc, pc = ref_opt.OptimizerConfig(**cfg), opt.OptimizerConfig(**cfg)
        for step in range(0, 120, 3):
            want = float(ref_opt.schedule(rc, step))
            got = opt.schedule(pc, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 1e-6 * abs(want), (cfg, step)


def test_global_norm_and_clipping_match_reference():
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(np.float32) * 30
              for s in ((3, 4), (7,), (2, 5, 6))]
    want = float(ref_opt.global_norm([jnp.asarray(a) for a in leaves]))
    got = float(opt.global_norm([torch.as_tensor(a) for a in leaves]))
    assert abs(got - want) <= 1e-6 * want
    # the clipped step: every leaf scaled by clip / norm before Adam
    params = {f"p{i}": np.zeros_like(a) for i, a in enumerate(leaves)}
    grads = {f"p{i}": a for i, a in enumerate(leaves)}
    cfg = dict(lr=0.1, warmup_steps=0, total_steps=10, clip_norm=1.0,
               weight_decay=0.0)
    rp, rs, rm = ref_opt.apply_updates(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in grads.items()},
        ref_opt.init({k: jnp.asarray(v) for k, v in params.items()}),
        ref_opt.OptimizerConfig(**cfg))
    pp = [torch.as_tensor(v) for v in params.values()]
    ps, pm = opt.apply_updates(pp, [torch.as_tensor(v)
                                    for v in grads.values()],
                               opt.init(pp), opt.OptimizerConfig(**cfg),
                               [a.ndim for a in leaves])
    assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) \
        <= 1e-6 * float(rm["grad_norm"])
    for i, k in enumerate(params):
        np.testing.assert_allclose(pp[i].numpy(), np.asarray(rp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ps.mu[i].numpy(), np.asarray(rs.mu[k]),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_updates_matches_reference(arch):
    """Three AdamW steps from the same state with the same gradients
    (drawn with numpy, varied in scale per leaf, clipped): parameters,
    both moments and the step within 1e-6 of each leaf's largest
    magnitude."""
    params, model = _pair(arch)
    flat = _flatten(params)
    rng = np.random.default_rng(1)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=20, weight_decay=0.1,
               clip_norm=1.0)
    rcfg, pcfg = ref_opt.OptimizerConfig(**cfg), opt.OptimizerConfig(**cfg)
    rstate = ref_opt.init(params)
    plist = list(model.parameters())
    pstate = opt.init(plist)
    ranks = ckpt.leaf_ranks(model)
    ref_step = jax.jit(ref_opt.apply_updates, static_argnums=3)
    for _ in range(3):
        gflat = {k: (rng.standard_normal(v.shape)
                     * 10.0 ** rng.uniform(-3, 1)).astype(np.float32)
                 for k, v in flat.items()}
        params, rstate, rm = ref_step(params, _tree(params, gflat), rstate,
                                      rcfg)
        pstate, pm = opt.apply_updates(plist, _per_param(model, gflat),
                                       pstate, pcfg, ranks)
        assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) \
            <= 1e-6 * float(rm["grad_norm"])
        assert abs(float(pm["lr"]) - float(rm["lr"])) <= 1e-6 * float(
            rm["lr"])
    assert int(pstate.step) == int(rstate.step) == 3
    index = {p: i for i, p in enumerate(plist)}
    for name, got, want in (
            ("params", ckpt.to_flat(model), _flatten(params)),
            ("mu", ckpt.to_flat(model, lambda p: pstate.mu[index[p]]),
             _flatten(rstate.mu)),
            ("nu", ckpt.to_flat(model, lambda p: pstate.nu[index[p]]),
             _flatten(rstate.nu))):
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            err = np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= 1e-6, (name, k, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_matches_reference(arch):
    params, model = _pair(arch)
    flat = _flatten(params)
    leaves = ckpt.leaf_map(model)
    assert set(leaves) == set(flat)
    rank = dict(zip(model.parameters(), ckpt.leaf_ranks(model)))
    for key, (ts, stacked) in leaves.items():
        for t in ts:
            assert rank[t] == flat[key].ndim, key
            assert opt._decay_mask(rank[t]) == ref_opt._decay_mask(
                flat[key]), key
    decayed = {k for k in flat if opt._decay_mask(flat[k].ndim)}
    assert "ln_f/g" not in decayed
    gain = {"zamba2-7b": "stacks/0/0/ln/g",
            "whisper-small": "stacks/0/0/self/ln1/g"}.get(arch,
                                                        "stacks/0/0/ln1/g")
    assert gain in decayed
    if arch == "zamba2-7b":
        assert {"stacks/0/0/mamba/a_log", "stacks/0/0/mamba/d_skip",
                "stacks/0/0/mamba/dt_bias",
                "stacks/0/0/mamba/norm/g"} <= decayed
        assert "shared/ln1/g" not in decayed
    if arch == "whisper-small":
        assert "stacks/0/0/ln_x/b" in decayed
        assert "enc/stack/0/ln1/b" in decayed
        assert "enc/ln/g" not in decayed
    if arch == "deepseek-v3-671b":
        assert not {k for k in decayed if k.startswith("mtp/")
                    and k.endswith("/g")}


# ---------------------------------------------------------------------------
# the reference's optimizer tests (tests/test_training.py), for the port
# ---------------------------------------------------------------------------

def test_adamw_quadratic_converges():
    target = torch.tensor([1.0, -2.0, 3.0])
    w = torch.zeros(3)
    cfg = opt.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=400,
                              weight_decay=0.0, clip_norm=None)
    state = opt.init([w])
    for _ in range(400):
        state, _ = opt.apply_updates([w], [2 * (w - target)], state, cfg, [1])
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=1e-2)


def test_adamw_first_step_magnitude():
    w = torch.zeros(4)
    cfg = opt.OptimizerConfig(lr=0.5, warmup_steps=0, total_steps=10,
                              weight_decay=0.0, clip_norm=None)
    opt.apply_updates([w], [torch.tensor([1.0, -1.0, 2.0, -0.5])],
                      opt.init([w]), cfg, [1])
    lr1 = float(opt.schedule(cfg, 1))
    np.testing.assert_allclose(np.abs(w.numpy()), lr1, rtol=1e-3)
    assert np.sign(w.numpy()).tolist() == [-1, 1, -1, 1]


def test_grad_clipping():
    w = torch.zeros(3)
    cfg = opt.OptimizerConfig(lr=1.0, warmup_steps=0, total_steps=10,
                              clip_norm=1.0, weight_decay=0.0)
    _, m = opt.apply_updates([w], [torch.tensor([300.0, 400.0, 0.0])],
                             opt.init([w]), cfg, [1])
    assert abs(float(m["grad_norm"]) - 500.0) < 1e-3


def test_schedule_shape():
    cfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                              min_lr_ratio=0.1)
    s = [float(opt.schedule(cfg, i)) for i in range(0, 101, 10)]
    assert s[0] == 0.0
    assert abs(s[1] - 1e-3) < 1e-9
    assert s[-1] <= 1.1e-4 + 1e-9
    assert all(a >= b - 1e-12 for a, b in zip(s[1:], s[2:]))


def test_weight_decay_only_on_matrices():
    w, g = torch.ones((2, 2)), torch.ones(4)
    cfg = opt.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=10,
                              weight_decay=1.0, clip_norm=None)
    opt.apply_updates([w, g], [torch.zeros(2, 2), torch.zeros(4)],
                      opt.init([w, g]), cfg, [w.ndim, g.ndim])
    assert float(w[0, 0]) < 1.0
    assert float(g[0]) == 1.0


def test_moments_inherit_the_parameter_dtype():
    """A bf16 linear keeps bf16 moments and a fp32 gain fp32 ones; the
    update runs in fp32 and lands in the parameter's dtype."""
    w = torch.full((2, 3), 0.5, dtype=torch.bfloat16)
    g = torch.ones(3)
    state = opt.init([w, g])
    assert [m.dtype for m in state.mu] == [torch.bfloat16, torch.float32]
    cfg = opt.OptimizerConfig(lr=0.25, warmup_steps=0, total_steps=10,
                              weight_decay=0.0, clip_norm=None)
    state, _ = opt.apply_updates([w, g], [torch.ones_like(w),
                                          torch.ones_like(g)], state, cfg,
                                 [2, 1])
    assert w.dtype == torch.bfloat16 and state.nu[0].dtype == torch.bfloat16
    want = torch.tensor(0.5 - float(opt.schedule(cfg, 1))).bfloat16()
    assert bool((w == want).all()), (w, want)
