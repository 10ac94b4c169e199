"""The port's continuous batching (``Engine.serve`` over the paged pool)
against the JAX reference at smoke size, on the CPU.

Both packages run the same weights: the reference's initial parameters go
through the weight bridge (``training/checkpoint.py::from_flat``).  Greedy
tokens of the port's ``serve`` must equal the reference's ``serve`` and the
port's own per-request ``generate``, for dense attention, QUOKA through the
staged route and QUOKA g = 16 through the fused route, on granite-3-2b,
qwen3-4b, llama3-2-3b, stablelm-3b (MHA) and olmoe-1b-7b; the step
counts and prefix hits must be the reference's too (deepseek-v3's latent
caches: ``test_torch_latent_pool.py``).
Also covered: a prefix-cache hit, a COW tail, a pool small enough to
queue, a ragged tail chunk, EOS, suspend/resume with no host tier, the
streaming front end, and the options that are not ported yet.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.model import build_model as ref_build
from repro.serving import request as ref_rq
from repro.serving.engine import Engine as RefEngine
from repro.serving.request import make_requests as ref_requests
from repro.training.checkpoint import _flatten
import repro_torch.serving.engine as eng_mod
from repro_torch.configs import get_config as port_config
from repro_torch.kernels import flash_attention, quoka_score
from repro_torch.kernels import selected_attention
from repro_torch.serving import request as rq
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import make_requests
from repro_torch.training.checkpoint import from_flat

torch.set_num_threads(2)

BS = 16
VARIANTS = {
    "full": ("full", {}),
    "quoka_staged": ("quoka", {}),
    "quoka_g16_fused": ("quoka", {"granularity": 16,
                                  "fused_select_attn": True}),
}


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


def _same_tokens(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-4b", "llama3-2-3b",
                                  "stablelm-3b", "olmoe-1b-7b"])
def test_serve_matches_reference_and_generate(arch, variant):
    """A ragged tail (24) and interleaved prefill/decode steps; greedy
    tokens, step counts and occupancy equal the reference's serve, and each
    request equals its own ``generate`` (the ragged prompt is left out for
    the fused route, where the reference's serve and generate chunk it on
    different grids)."""
    method, qover = VARIANTS[variant]
    rm, params, pm = _pair(arch, qover)
    prompts = _prompts(3, (16, 48, 32, 24), rm.cfg.vocab)
    kw = dict(block_size=BS, max_decode_batch=4, max_prefill_tokens=32)
    want = RefEngine(rm, params, method=method).serve(
        ref_requests(prompts, 6), **kw)
    eng = Engine(pm, method=method, device="cpu")
    got = eng.serve(make_requests(prompts, 6), **kw)
    _same_tokens(got.tokens, want.tokens)
    assert (got.steps, got.prefill_steps, got.decode_steps) == \
        (want.steps, want.prefill_steps, want.decode_steps)
    assert got.occupancy == pytest.approx(want.occupancy)
    assert got.device == "cpu" and all(t > 0 for t in got.ttft_s.values())
    for i, pr in enumerate(prompts):
        if variant == "quoka_g16_fused" and len(pr) % BS:
            continue
        one = eng.generate(eng.pad_prompt(pr[None]), 6).tokens[0]
        np.testing.assert_array_equal(got.tokens[i], one)


def test_tail_packing_end_to_end_matches_reference(granite):
    """``max_prefill_rows=2`` with a one-chunk token budget: two sub-chunk
    prompts prefill in one engine step, with the reference's tokens and
    each request's own ``generate``."""
    rm, params, pm = granite
    chunk = pm.cfg.quoka.chunk_size
    prompts = _prompts(41, (chunk // 2 - 1, chunk // 2), rm.cfg.vocab)
    kw = dict(block_size=BS, max_decode_batch=2, max_prefill_tokens=chunk,
              max_prefill_rows=2)
    want = RefEngine(rm, params, method="full").serve(
        ref_requests(prompts, 4), **kw)
    eng = Engine(pm, method="full", device="cpu")
    got = eng.serve(make_requests(prompts, 4), **kw)
    assert got.prefill_steps == want.prefill_steps == 1
    _same_tokens(got.tokens, want.tokens)
    for i, pr in enumerate(prompts):
        np.testing.assert_array_equal(
            got.tokens[i], eng.generate(eng.pad_prompt(pr[None]), 4).tokens[0])


@pytest.mark.parametrize("method", ["full", "quoka"])
def test_prefix_hit_matches_reference(granite, method):
    """Pass 2 over a warm pool admits every request through a prefix hit
    (on the chunk grid for quoka) with the reference's hit lengths, stats
    and tokens."""
    rm, params, pm = granite
    sys_tok = _prompts(3, (48,), rm.cfg.vocab)[0]
    prompts = [np.concatenate([sys_tok, s])
               for s in _prompts(4, (16, 16, 16), rm.cfg.vocab)]
    reng = RefEngine(rm, params, method=method)
    eng = Engine(pm, method=method, device="cpu")
    rstate = reng.make_serve_state(ref_requests(prompts, 6), block_size=BS,
                                   max_decode_batch=4)
    state = eng.make_serve_state(make_requests(prompts, 6), block_size=BS,
                                 max_decode_batch=4)
    for _ in ("cold", "hot"):
        want = reng.serve(ref_requests(prompts, 6), state=rstate)
        got = eng.serve(make_requests(prompts, 6), state=state)
        _same_tokens(got.tokens, want.tokens)
        assert got.cached_len == want.cached_len
        assert got.prefix == pytest.approx(dict(want.prefix))
    assert all(v > 0 for v in got.cached_len.values())
    assert eng.stats["cache_hits"] == 3
    state.pool.check_invariants()


def test_cow_shared_tail_matches_reference(granite):
    """Turn 2 extends turn 1's ragged prompt: the shared prefix ends inside
    a block and is served by a copy-on-write clone (dense attention hits
    at token granularity)."""
    rm, params, pm = granite
    base = _prompts(5, (40,), rm.cfg.vocab)[0]
    turn2 = np.concatenate([base, _prompts(6, (13,), rm.cfg.vocab)[0]])
    reng = RefEngine(rm, params, method="full")
    eng = Engine(pm, method="full", device="cpu")
    rstate = reng.make_serve_state(ref_requests([base, turn2], 4),
                                   block_size=BS, max_decode_batch=2)
    state = eng.make_serve_state(make_requests([base, turn2], 4),
                                 block_size=BS, max_decode_batch=2)
    _same_tokens(eng.serve(make_requests([base], 4), state=state).tokens,
                 reng.serve(ref_requests([base], 4), state=rstate).tokens)
    got = eng.serve([rq.Request(rid=9, tokens=turn2, max_new=4)],
                    state=state)
    want = reng.serve([ref_rq.Request(rid=9, tokens=turn2, max_new=4)],
                      state=rstate)
    assert got.cached_len[9] == want.cached_len[9] == 40
    assert eng.stats["cow_copies"] == 1
    _same_tokens(got.tokens, want.tokens)
    one = eng.generate(eng.pad_prompt(turn2[None]), 4).tokens[0]
    np.testing.assert_array_equal(got.tokens[9], one)


def test_small_pool_queues_like_reference(granite):
    """A pool that fits about one request forces admission queueing; the
    steps and tokens are the reference's and every block comes back."""
    rm, params, pm = granite
    prompts = _prompts(5, (32, 32, 32), rm.cfg.vocab)
    kw = dict(block_size=BS, num_blocks=3, max_decode_batch=4)
    want = RefEngine(rm, params, method="quoka").serve(
        ref_requests(prompts, 4), **kw)
    got = Engine(pm, method="quoka", device="cpu").serve(
        make_requests(prompts, 4), **kw)
    _same_tokens(got.tokens, want.tokens)
    assert got.decode_steps == want.decode_steps >= 9


def test_eos_stops_like_reference(granite):
    rm, params, pm = granite
    prompts = _prompts(7, (32, 16), rm.cfg.vocab)
    eng = Engine(pm, method="quoka", device="cpu")
    free_run = eng.serve(make_requests(prompts, 8), block_size=BS)
    eos = int(free_run.tokens[0][2])
    got = eng.serve(make_requests(prompts, 8, eos_id=eos), block_size=BS)
    want = RefEngine(rm, params, method="quoka").serve(
        ref_requests(prompts, 8, eos_id=eos), block_size=BS)
    _same_tokens(got.tokens, want.tokens)
    assert got.tokens[0][-1] == eos and len(got.tokens[0]) <= 3


def _drive(eng, state, reqs, hook=None, max_steps=500):
    sched = state.sched
    for r in reqs:
        sched.add(r)
    steps = 0
    while sched.pending():
        if hook is not None:
            hook(state, steps)
        n_pf, n_dec = eng.step(state)
        assert n_pf or n_dec or not sched.pending(), "scheduler stall"
        steps += 1
        assert steps < max_steps, "drive did not drain"
    state.pool.check_invariants()
    return {r.rid: np.asarray(r.out, np.int32) for r in sched.done}


@pytest.mark.parametrize("method", ["full", "quoka"])
def test_suspend_resume_token_identity(granite, method):
    """Preempting a decoding request and resuming it (KV parked on the LRU
    list: no host tier) gives the tokens of an uninterrupted run, which are
    the reference's."""
    rm, params, pm = granite
    prompt = _prompts(23, (40,), rm.cfg.vocab)[0]
    kw = dict(block_size=BS, max_decode_batch=2, policy="slo")
    want = RefEngine(rm, params, method=method).serve(
        ref_requests([prompt], 8), **kw)
    eng = Engine(pm, method=method, device="cpu")
    state = eng.make_serve_state(make_requests([prompt], 8), **kw)
    ref_run = _drive(eng, state, make_requests([prompt], 8))[0]
    state = eng.make_serve_state(make_requests([prompt], 8), **kw)
    forced = []

    def force_suspend(st, step):
        r = st.sched.decoding[0] if st.sched.decoding else None
        if not forced and r is not None and len(r.out) >= 3:
            st.sched.suspend(r, st.now)
            forced.append(r)

    out = _drive(eng, state, make_requests([prompt], 8),
                 hook=force_suspend)[0]
    assert state.sched.policy.name == "slo"
    assert forced and forced[0].preemptions == 1
    assert state.sched.resumes == 1 and state.sched.resume_replays == 0
    np.testing.assert_array_equal(out, ref_run)
    np.testing.assert_array_equal(out, np.asarray(want.tokens[0]))


def test_ragged_tail_chunk_is_garbage_independent(granite):
    """Whatever sits in a ragged tail chunk's pad slots must not reach the
    valid rows (pad queries are kept out of QUOKA's chunk statistics); the
    last valid hidden state is the reference's."""
    rm, params, pm = granite
    chunk = pm.cfg.quoka.chunk_size
    rng = np.random.default_rng(9)
    toks = rng.integers(3, pm.cfg.vocab, (1, 2 * chunk)).astype(np.int32)
    tail = rng.integers(3, pm.cfg.vocab, (1, 5)).astype(np.int32)
    outs = []
    for fill in (0, 7):
        cache = pm.init_cache(1, 3 * chunk)
        for c0 in range(0, 2 * chunk, chunk):
            pm.prefill_chunk({"tokens": toks[:, c0:c0 + chunk]}, c0, cache,
                             "quoka")
        buf = np.full((1, chunk), fill, np.int32)
        buf[:, :5] = tail
        last, _ = pm.prefill_chunk({"tokens": buf}, 2 * chunk, cache,
                                   "quoka", valid_len=np.asarray([5]))
        outs.append(last.numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    rcache = rm.init_cache(1, 3 * chunk)
    for c0 in range(0, 2 * chunk, chunk):
        _, rcache = rm.prefill_chunk(
            params, {"tokens": jnp.asarray(toks[:, c0:c0 + chunk])},
            jnp.asarray(c0), rcache, "quoka", backend="xla")
    rlast, _ = rm.prefill_chunk(params, {"tokens": jnp.asarray(buf)},
                                jnp.asarray(2 * chunk), rcache, "quoka",
                                backend="xla", valid_len=jnp.asarray([5]))
    np.testing.assert_allclose(outs[1], np.asarray(rlast), atol=1e-4, rtol=0)


def test_idle_wait_sleeps_until_next_arrival(granite, monkeypatch):
    """A one-second arrival gap costs a few capped sleeps, not a busy spin,
    and leaves the step counts alone."""
    import time as time_mod
    rm, params, pm = granite
    eng = Engine(pm, method="full", device="cpu")
    prompts = _prompts(13, (16, 16), pm.cfg.vocab)
    kw = dict(block_size=BS, max_decode_batch=2)
    real_sleep, calls = time_mod.sleep, []

    def counting_sleep(s):
        calls.append(s)
        real_sleep(min(s, 0.3))

    monkeypatch.setattr(eng_mod.time, "sleep", counting_sleep)
    res = eng.serve(make_requests(prompts, 3, arrivals=[0.0, 1.0]), **kw)
    assert res.steps == 4 and res.prefill_steps == 2 \
        and res.decode_steps == 4
    assert 1 <= len(calls) <= 12
    assert all(len(v) == 3 for v in res.tokens.values())


def test_serve_stream_yields_per_step(granite):
    """serve_stream yields every (rid, token) as it is emitted; its return
    value is the ServeResult that ``serve`` gives."""
    rm, params, pm = granite
    eng = Engine(pm, method="full", device="cpu")
    prompts = _prompts(53, (16, 24), pm.cfg.vocab)
    kw = dict(block_size=BS, max_decode_batch=2)
    stream = eng.serve_stream(make_requests(prompts, 4), **kw)
    events = []
    while True:
        try:
            events.append(next(stream))
        except StopIteration as stop:
            res = stop.value
            break
    assert res.generated == len(events) == 8
    for rid in res.tokens:
        np.testing.assert_array_equal(
            np.asarray([t for r, t in events if r == rid], np.int32),
            res.tokens[rid])
    _same_tokens(eng.serve(make_requests(prompts, 4), **kw).tokens,
                 res.tokens)


def test_serve_state_guards(granite):
    """A warm state refuses options it does not hold, traces that outgrow
    its geometry and duplicate request ids; requests can be re-served."""
    rm, params, pm = granite
    eng = Engine(pm, method="quoka", device="cpu")
    small, big = _prompts(9, (16, 96), pm.cfg.vocab)
    state = eng.make_serve_state(make_requests([small], 4), block_size=BS,
                                 max_decode_batch=2)
    reqs = make_requests([small], 4)
    r1 = eng.serve(reqs, state=state)
    np.testing.assert_array_equal(eng.serve(reqs, state=state).tokens[0],
                                  r1.tokens[0])
    with pytest.raises(ValueError, match="make_serve_state"):
        eng.serve(make_requests([small], 4), state=state, prefix_cache=False)
    with pytest.raises(ValueError, match="fresh state"):
        eng.serve(make_requests([big], 4), state=state)
    with pytest.raises(ValueError, match="duplicate"):
        eng.serve(make_requests([small], 2) * 2, state=state)
    with pytest.raises(ValueError, match="never be admitted"):
        eng.serve(make_requests([big], 4), block_size=BS, num_blocks=2)


def test_unported_options_raise_and_cpu_serve_launches_no_kernel(granite):
    """Mesh serving still raises; the telemetry options it used to refuse
    with it (``registry=``, ``with_obs``) now run (``test_torch_obs.py``
    holds them to the reference)."""
    from repro_torch.obs import Registry
    rm, params, pm = granite
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Engine(pm, device="cpu", mesh=object())
    assert Engine(pm, device="cpu", registry=Registry())._obs_on
    eng = Engine(pm, method="quoka", device="cpu")
    pr = make_requests(_prompts(1, (16,), pm.cfg.vocab), 2)
    _, _, lobs = pm.prefill_chunk({"tokens": np.zeros((1, 16), np.int32)}, 0,
                                  pm.init_cache(1, 32), with_obs=True)
    assert lobs.sel_tokens.shape == (pm.cfg.n_layers,)
    for mod in (flash_attention, quoka_score, selected_attention):
        mod.LAUNCHES = 0
    selected_attention.PAGED_LAUNCHES = 0
    eng.serve(pr, block_size=BS)
    assert (flash_attention.LAUNCHES, quoka_score.LAUNCHES,
            selected_attention.LAUNCHES,
            selected_attention.PAGED_LAUNCHES) == (0, 0, 0, 0)


def test_latent_cache_serve_raises_and_generate_runs():
    """deepseek-v3's latent caches now have a paged-pool layout: ``serve``
    runs and gives each request its own ``generate``'s tokens (the
    reference's serve is matched in ``test_torch_latent_pool.py``); what
    still raises is a pool on a mesh (not yet ported), explicitly and with
    no fallback; the one-shot ``generate`` keeps the reference's tokens."""
    rm, params, pm = _pair("deepseek-v3-671b")
    prompts = _prompts(7, (64, 48), pm.cfg.vocab)
    eng = Engine(pm, method="quoka", device="cpu")
    from repro_torch.serving.pool import PagedKVCache
    with pytest.raises(NotImplementedError, match="not yet ported"):
        PagedKVCache(pm, num_blocks=8, block_size=BS, mesh=object())
    got = eng.serve(make_requests(prompts, 4), block_size=BS)
    for i, pr in enumerate(prompts):
        np.testing.assert_array_equal(
            got.tokens[i], eng.generate({"tokens": pr[None]}, 4).tokens[0])
    toks = np.stack([prompts[0], prompts[0][::-1]])
    want = RefEngine(rm, params, method="quoka").generate(
        {"tokens": jnp.asarray(toks)}, 4).tokens
    np.testing.assert_array_equal(eng.generate({"tokens": toks}, 4).tokens,
                                  np.asarray(want))


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_recurrent_arch_continuous_cli_raises_like_reference(arch):
    """``--continuous`` on a recurrent arch raises the paged pool's
    refusal, with the reference's message (its recurrent states have no
    pool layout), before any request is served."""
    from repro_torch.launch import serve
    kinds = "['mamba', 'mamba_shared_attn']" if arch == "zamba2-7b" else \
        "['rwkv']"
    with pytest.raises(ValueError) as err:
        serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--continuous", "--prompt-len", "32", "--n-requests",
                    "2", "--max-new", "2"])
    assert str(err.value) == (
        "paged KV pool supports attention/MLA caches only; model has "
        f"unsupported block kinds {kinds}")


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b"])
def test_modality_pool_refuses_like_reference(arch):
    """The paged pool refuses whisper (its ``dec_cross`` caches) and a VLM
    frontend with the reference's messages, so ``serve`` raises before any
    request is admitted; both families are one-shot only, as in the
    reference."""
    from repro.serving.pool import PagedKVCache as RefPool
    from repro_torch.serving.pool import PagedKVCache
    rm, _, pm = _pair(arch)
    with pytest.raises(ValueError) as want:
        RefPool(rm, num_blocks=8, block_size=BS)
    with pytest.raises(ValueError) as got:
        PagedKVCache(pm, num_blocks=8, block_size=BS)
    assert str(got.value) == str(want.value)
    assert str(got.value) == (
        "paged KV pool supports attention/MLA caches only; model has "
        "unsupported block kinds ['dec_cross']" if arch == "whisper-small"
        else "paged KV pool does not support VLM frontends")
    prompts = _prompts(12, (32,), pm.cfg.vocab)
    with pytest.raises(ValueError, match="paged KV pool"):
        Engine(pm, method="quoka", device="cpu").serve(
            make_requests(prompts, 2), block_size=BS)
