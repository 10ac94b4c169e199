"""The port trains a small model on the synthetic needle-retrieval task
until it solves it, then QUOKA's chunked prefill keeps the retrieval: the
reference's ``tests/test_system.py`` for the port, on the CPU, at the
same config, data, steps and thresholds (the weights are the port's own
draw from seed 0; the needle stream the reference's, ``REF_SEED``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import (REF_SEED, needle_accuracy,
                                        needle_batch, needle_batches)
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
from repro_torch.training import loop
from repro_torch.training import optimizer as opt

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def retrieval_model():
    torch.set_num_threads(2)
    cfg = get_config("granite-3-2b").smoke(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=256)
    cfg = dataclasses.replace(
        cfg, quoka=dataclasses.replace(cfg.quoka, chunk_size=32, budget=48,
                                       n_queries=8, keep_first=4))
    model = build_model(cfg, "cpu", seed=0)
    loop.train(model, needle_batches(REF_SEED, cfg.vocab, 16, 97, n_keys=16),
               steps=250, log_every=100, state=loop.init_state(model, None),
               ocfg=opt.OptimizerConfig(lr=3e-3, warmup_steps=20,
                                        total_steps=250))
    return model


def test_trained_model_solves_retrieval_dense(retrieval_model):
    model = retrieval_model
    batch = needle_batch(np.random.default_rng(7), model.cfg.vocab, 16, 97,
                         n_keys=16)
    assert needle_accuracy(model, batch, "full") >= 0.7


def test_quoka_preserves_retrieval(retrieval_model):
    """On prompts longer than the training ones (161), where every chunk
    selects (cache 168 > budget 48 + chunk 32)."""
    model = retrieval_model
    batch = needle_batch(np.random.default_rng(11), model.cfg.vocab, 16, 161,
                         n_keys=16)
    acc_full = needle_accuracy(model, batch, "full")
    acc_quoka = needle_accuracy(model, batch, "quoka")
    assert acc_quoka >= acc_full - 0.25, (acc_quoka, acc_full)


def test_generation_roundtrip(retrieval_model):
    model = retrieval_model
    eng = Engine(model, method="quoka", device="cpu")
    batch = needle_batch(np.random.default_rng(3), model.cfg.vocab, 4, 97,
                         n_keys=16)
    res = eng.generate(eng.pad_prompt(batch["tokens"][:, :-1]), 4)
    assert res.tokens.shape == (4, 4)
    assert res.ttft_s > 0 and np.isfinite(res.decode_tps)
