"""The port's training loop, data, checkpoints and launcher against the
JAX reference on the CPU, fp32 at smoke size.

Checked: ``lm_batches``, ``needle_batches`` and ``needle_batch`` give the
reference's token streams from the integer the reference derives from its
key (``REF_SEED`` for ``PRNGKey(0)``); five ``train`` steps on
``lm_batches`` track the reference's ``train`` loss for loss within 1e-4
relative (granite-3-2b and olmoe-1b-7b, from the same weights); ``save``
of a model is read by the reference's ``restore`` and a reference ``save``
by the port's ``restore``, and ``save`` of a whole training state (after
a step: nonzero moments) by the reference's ``restore`` into its
``TrainState`` and by the port's ``restore_state``, with ``load_meta``; a
checkpoint missing a parameter is refused; the launcher's CPU smoke in a
subprocess; one training step of every config at smoke size (the
reference's ``test_smoke_archs.py::test_one_train_step``); the entry
points' refusal to run without a card unless asked for the CPU.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data import synthetic as ref_data
from repro.models.model import build_model as ref_build
from repro.training import checkpoint as ref_ckpt
from repro.training import loop as ref_loop
from repro.training import optimizer as ref_opt
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config as port_config
from repro_torch.data import synthetic as data
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import loop
from repro_torch.training import optimizer as opt

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ARCHS = ["qwen3-4b", "granite-3-2b", "llama3-2-3b", "stablelm-3b",
         "olmoe-1b-7b", "deepseek-v3-671b", "gemma3-27b", "h2o-danube-3-4b",
         "zamba2-7b", "rwkv6-1.6b", "whisper-small", "internvl2-1b"]


def _pair(arch):
    rm = ref_build(ref_config(arch).smoke())
    params = rm.init(KEY)
    return rm, params, ckpt.from_flat(_flatten(params),
                                      port_config(arch).smoke(), "cpu")


def test_ref_seed_is_the_reference_draw():
    assert data.REF_SEED == int(jax.random.randint(KEY, (), 0, 2**31 - 1))


def test_data_streams_match_reference():
    rl, pl = ref_data.lm_batches(KEY, 97, 4, 80), \
        data.lm_batches(data.REF_SEED, 97, 4, 80)
    rn, pn = ref_data.needle_batches(KEY, 128, 3, 65, n_keys=16,
                                     n_distractors=2), \
        data.needle_batches(data.REF_SEED, 128, 3, 65, n_keys=16,
                            n_distractors=2)
    for _ in range(3):
        np.testing.assert_array_equal(next(pl)["tokens"],
                                      np.asarray(next(rl)["tokens"]))
        want, got = next(rn), next(pn)
        np.testing.assert_array_equal(got["tokens"],
                                      np.asarray(want["tokens"]))
        np.testing.assert_array_equal(got["loss_mask"],
                                      np.asarray(want["loss_mask"]))
    want = ref_data.needle_batch(np.random.default_rng(4), 256, 5, 161,
                                 n_keys=16, depth=0.8)
    got = data.needle_batch(np.random.default_rng(4), 256, 5, 161,
                            n_keys=16, depth=0.8)
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    assert got["tokens"].dtype == np.int32


@pytest.mark.parametrize("arch", ["granite-3-2b", "olmoe-1b-7b"])
def test_five_steps_track_reference(arch):
    """Losses, not parameters: Adam's first step is about sign(g) * lr, so
    an entry whose gradient is near zero may flip with no fault."""
    rm, params, model = _pair(arch)
    cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    _, want = ref_loop.train(
        rm, ref_data.lm_batches(KEY, rm.cfg.vocab, 2, 64),
        ocfg=ref_opt.OptimizerConfig(**cfg), key=KEY, steps=5, log_every=1)
    _, got = loop.train(model, data.lm_batches(data.REF_SEED,
                                               model.cfg.vocab, 2, 64),
                        ocfg=opt.OptimizerConfig(**cfg), steps=5,
                        log_every=1, state=loop.init_state(model, None))
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(5))
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= 1e-4 * abs(b), (got, want)


def test_params_checkpoint_round_trips_through_reference(tmp_path):
    rm, params, model = _pair("whisper-small")
    path = str(tmp_path / "params.npz")
    ckpt.save(path, model, {"arch": "whisper-small", "steps": 0})
    back = ref_ckpt.restore(path, params)
    for k, v in _flatten(params).items():
        np.testing.assert_array_equal(_flatten(back)[k], v)
    assert ckpt.load_meta(path) == {"arch": "whisper-small", "steps": 0}
    # and the reference's own save into the port
    ref_path = str(tmp_path / "ref.npz")
    ref_ckpt.save(ref_path, params, {"steps": 3})
    again = ckpt.restore(ref_path, port_config("whisper-small").smoke(),
                         "cpu")
    for k, v in ckpt.to_flat(again).items():
        np.testing.assert_array_equal(v, _flatten(params)[k])
    assert ckpt.load_meta(ref_path)["steps"] == 3


def test_train_state_checkpoint_round_trips(tmp_path):
    """A state after one step: the reference restores it into its
    ``TrainState`` template key for key, and the port's
    ``restore_state`` gives back the parameters, the moments and the
    step."""
    rm, params, model = _pair("olmoe-1b-7b")
    state = loop.init_state(model, None)
    step = loop.make_train_step(model, opt.OptimizerConfig(
        lr=1e-3, warmup_steps=1, total_steps=10))
    batch = next(data.lm_batches(1, model.cfg.vocab, 2, 32))
    state, _ = step(state, batch)
    path = str(tmp_path / "state.npz")
    ckpt.save(path, state, {"step": 1})
    template = ref_loop.TrainState(params=params, opt=ref_opt.init(params))
    back = _flatten(ref_ckpt.restore(path, template))
    saved = ckpt.state_flat(state.model, state.opt)
    assert set(back) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v)
    assert int(back["opt/step"]) == 1
    assert np.abs(back["opt/nu/stacks/0/0/wq/w"]).max() > 0
    model2, ostate = ckpt.restore_state(path, model.cfg, "cpu")
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a.detach(), b)
    for m_a, m_b in zip(state.opt.mu + state.opt.nu, ostate.mu + ostate.nu):
        assert torch.equal(m_a, m_b)
    assert int(ostate.step) == 1 and ckpt.load_meta(path) == {"step": 1}


def test_checkpoint_missing_a_parameter_raises(tmp_path):
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="lacks parameters"):
        ckpt.restore(path, port_config("granite-3-2b").smoke(), "cpu")


def test_train_launcher_smoke():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "olmoe-1b-7b", "--smoke", "--steps", "3", "--batch", "2", "--seq",
         "64", "--device", "cpu"],
        env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "2"},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "loss" in r.stdout and "tok/s on cpu" in r.stdout


def test_train_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    from repro_torch.launch import train, train_retrieval
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_retrieval.main(["--steps", "1"])
    with pytest.raises(ValueError, match="needs 2 devices but 1 are"):
        train.main(["--smoke", "--host-mesh", "2x1", "--device", "cpu"])
    run = train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq",
                      "32", "--device", "cpu"])
    assert run.device == "cpu" and len(run.step_s) == 2
    assert run.peak_gib is None and run.tokens_per_step == 64


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step(arch):
    """One step of every config at smoke size: finite loss and gradient
    norm, and every parameter that the loss reaches moved."""
    cfg = port_config(arch).smoke()
    model = build_model(cfg, "cpu", seed=0)
    state = loop.init_state(model, None)
    before = [p.detach().clone() for p in model.parameters()]
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (2, cfg.frontend.n_tokens, cfg.frontend.d_in)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (2, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    step = loop.make_train_step(model, opt.OptimizerConfig(
        lr=1e-3, warmup_steps=1, total_steps=10))
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(state.opt.step) == 1
    moved = [not torch.equal(a, p) for a, p in zip(before,
                                                    model.parameters())]
    assert all(moved), sum(moved)
