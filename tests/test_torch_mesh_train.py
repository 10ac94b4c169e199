"""Sharded training of the port on the ``pod``, ``data`` and ``model``
mesh axes, against the reference's ``jax.value_and_grad`` and the port's
meshless run (CPU, fp32, gloo ranks).

One ``launch/mesh.py::spawn_ranks`` per world size (4, 2 and 3 ranks,
side by side; the rank bodies are ``tests/torch_train_cases.py``), while
the reference's and the port's meshless runs go on in this process, on
the reference's flat weights (``jax.random.PRNGKey(0)`` through
``from_flat``) and the same numpy batches:

  * ``data=2,model=2``: granite-3-2b at batch 3 (rows the data degree
    does not divide: the whole batch on every data rank) with a
    ``loss_mask``; olmoe-1b-7b smoke at ``n_heads=4, n_kv_heads=2`` (the
    reference's ``test_sharding.py`` geometry) with capacity factor 0.5,
    so pairs drop; deepseek-v3 (``mla``, ``mla_moe``, MTP); whisper-small;
    internvl2-1b; and granite at ``pod=2,data=2`` batch 4 (FSDP over the
    flattened group) in the same spawn;
  * ``model=2``: gemma3-27b and h2o-danube-3-4b (96 tokens past the
    64-token window), zamba2-7b (96 tokens), rwkv6-1.6b (40);
  * ``model=3``: llama3-2-3b at 6 query and 2 KV heads (GQA groups of 3
    straddle ranks).

Every mesh run recomputes each layer in the backward (remat).  Checked:
the loss within 1e-5 relative and every gradient leaf within 1e-4 of its
largest magnitude (rwkv6 5e-3, ``test_torch_train_families.py``'s)
against ``jax.value_and_grad`` of the reference's ``Model.loss`` and
against the meshless port; every leaf with a meshless gradient has one
on the mesh; two AdamW steps with clipping that binds give the meshless
losses and gradient norms within 1e-5 and each leaf's update within 1e-3
relative in L2 (rwkv6: within what a 1e-7 relative nudge of its weights
moves the meshless run, its fp32 conditioning); olmoe's aux loss equals the reference's and its dropped
pairs (the ranks' rows in rank order) the meshless run's.  The launcher
trains under ``--host-mesh 2x2`` (rank 0 alone prints), its ``--save``
writes the meshless file's keys with values within those bounds, a
sharded training state saved and restored (``restore_state`` then
``shard``) resumes with the same next loss (and only the first rank
copied the whole leaves to host memory), a ``generate`` on a
trained sharded model counts no backward bytes, and ``--host-mesh 1x1``
joins its group from the process's environment as a ``torchrun`` rank
does.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.model import build_model as ref_build
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config
from repro_torch.launch import mesh as lm
from repro_torch.launch import train as port_train
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import loop

import torch_train_cases as tc

torch.set_num_threads(2)

DM, POD = "data=2,model=2", "pod=2,data=2"
MOE = "olmoe-1b-7b"
RWKV_GRAD_TOL = 5e-3            # test_torch_train_families.py's
CLIP = 0.05                     # binds: every smoke gradient norm is larger
LAUNCH = ["--device", "cpu", "--smoke", "--steps", "3", "--batch", "2",
          "--seq", "64"]


def _moe_over():
    moe = dataclasses.replace(get_config(MOE).smoke().moe,
                              dispatch="capacity", capacity_factor=0.5)
    return {"n_kv_heads": 2, "moe": moe}


#: name -> (mesh, arch, smoke overrides, batch, tokens, loss_mask)
RUNS = {
    "granite_dm_b3": (DM, "granite-3-2b", {}, 3, 32, True),
    "olmoe_dm": (DM, MOE, _moe_over(), 2, 32, False),
    "deepseek_dm": (DM, "deepseek-v3-671b", {}, 2, 32, False),
    "whisper_dm": (DM, "whisper-small", {}, 2, 32, False),
    "internvl2_dm": (DM, "internvl2-1b", {}, 2, 32, False),
    "granite_pod_b4": (POD, "granite-3-2b", {}, 4, 32, False),
    "gemma3_m2": ("model=2", "gemma3-27b", {}, 2, 96, False),
    "danube_m2": ("model=2", "h2o-danube-3-4b", {}, 2, 96, False),
    "zamba2_m2": ("model=2", "zamba2-7b", {}, 2, 96, False),
    "rwkv6_m2": ("model=2", "rwkv6-1.6b", {}, 2, 40, False),
    "llama_m3": ("model=3", "llama3-2-3b",
                 {"n_heads": 6, "n_kv_heads": 2, "vocab": 513}, 2, 32,
                 False),
}
WORLDS = {4: [n for n, r in RUNS.items() if r[0] in (DM, POD)],
          2: [n for n, r in RUNS.items() if r[0] == "model=2"],
          3: ["llama_m3"]}


def _ref_cfg(arch, over):
    rcfg = ref_config(arch).smoke(**{k: v for k, v in over.items()
                                     if k != "moe"})
    if "moe" in over:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, **{f: getattr(over["moe"], f)
                         for f in ("dispatch", "capacity_factor")}))
    return rcfg


def _port_cfg(arch, over, remat=False):
    return tc.train_cfg(arch, over, remat=remat)


def _cfgkw(arch, over):
    return dict(arch=arch, over=over, remat=True)


def _inputs():
    """name -> (flat reference weights, batches), and the reference's
    parameter trees."""
    out, params = {}, {}
    for name, (spec, arch, over, b, t, mask) in RUNS.items():
        rm = ref_build(_ref_cfg(arch, over))
        params[name] = rm.init(jax.random.PRNGKey(0))
        flat = {k: np.asarray(v) for k, v in _flatten(params[name]).items()}
        cfg = _port_cfg(arch, over)
        out[name] = (flat, tc.train_batches(cfg, b, t, seed=7, mask=mask))
    return out, params


def _world_runs(w, inputs):
    runs = []
    for name in WORLDS[w]:
        spec, arch, over = RUNS[name][:3]
        flat, batches = inputs[name]
        runs.append((name, (spec, _cfgkw(arch, over), flat, batches, CLIP),
                     dict(drops=name == "olmoe_dm",
                          generate=name == "granite_dm_b3")))
    return runs


def _meshless(name, inputs, params):
    """The reference's loss and gradients and the port's meshless steps
    of one run (and olmoe's meshless drops and the reference's aux)."""
    spec, arch, over = RUNS[name][:3]
    flat, batches = inputs[name]
    rm = ref_build(_ref_cfg(arch, over))
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    rloss, rgrads = jax.jit(jax.value_and_grad(rm.loss))(params[name], jb)
    cfg = _port_cfg(arch, over)
    dev = torch.device("cpu")
    out = {"ref_loss": float(rloss),
           "ref_grads": {k: np.asarray(v)
                         for k, v in _flatten(rgrads).items()},
           "port": tc.run_steps(tc._model(cfg, flat, dev), batches, CLIP,
                                dev)}
    if name == "rwkv6_m2":
        rng = np.random.default_rng(1)
        nudged = {k: (v * (1 + 1e-7 * rng.standard_normal(v.shape))).astype(
            v.dtype) for k, v in flat.items()}
        out["nudged"] = tc.compare(tc.run_steps(
            tc._model(cfg, nudged, dev), batches, CLIP, dev), out["port"])
    if name == "olmoe_dm":
        out["drops"], _ = tc._drops_and_aux(tc._model(cfg, flat, dev),
                                            batches[0], None)
        out["ref_aux"] = float(jax.jit(rm.train_logits)(params[name],
                                                        jb)[1])
    return out


def _resume_meshless(inputs):
    """The meshless port: one step, its saved state, the next step's
    loss and grad norm."""
    flat, batches = inputs["granite_dm_b3"]
    cfg = _port_cfg("granite-3-2b", {})
    model = tc._model(cfg, flat, torch.device("cpu"))
    step = loop.make_train_step(model, tc.ocfg(CLIP))
    state, _ = step(loop.init_state(model, None), batches[0])
    flat1 = ckpt.state_flat(state.model, state.opt)
    _, met = step(state, batches[1])
    return flat, flat1, (float(met["loss"]), float(met["grad_norm"]))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(name -> every rank's result, name -> the meshless results, the
    files and meshless results of the launcher and resume checks)."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    inputs, params = _inputs()
    runs = {w: _world_runs(w, inputs) for w in WORLDS}
    flat, batches = inputs["granite_dm_b3"]
    state_path = str(tmp / "state.npz")
    mesh_save, flat_save = str(tmp / "mesh.npz"), str(tmp / "flat.npz")
    with ThreadPoolExecutor(len(runs) + 1) as pool:
        futs = {w: pool.submit(lm.spawn_ranks, tc.train_world, w, r,
                               timeout=300) for w, r in runs.items()}
        extra = pool.submit(
            lm.spawn_ranks, tc.extra_world, 4, DM,
            _cfgkw("granite-3-2b", {}), flat, batches, CLIP, state_path,
            LAUNCH + ["--host-mesh", "2x2", "--save", mesh_save],
            timeout=300)
        want = {name: _meshless(name, inputs, params) for name in RUNS}
        want["resume"] = _resume_meshless(inputs)
        want["launch"] = port_train.main(LAUNCH + ["--save", flat_save])
        res = {}
        for f in futs.values():
            for rank in f.result():
                for name, r in rank.items():
                    res.setdefault(name, []).append(r)
        res["extra"] = extra.result()
    files = {"state": state_path, "mesh": mesh_save, "flat": flat_save}
    return res, want, files


def _tol(name):
    return RWKV_GRAD_TOL if name == "rwkv6_m2" else tc.GRAD_TOL


@pytest.mark.parametrize("name", list(RUNS))
def test_loss_and_gradients_equal_reference_and_meshless(trained, name):
    res, want, _ = trained
    got, w = res[name][0], want[name]
    for r in res[name][1:]:
        assert "grads" not in r              # only the first rank gathers
    rel = abs(got["loss"] - w["ref_loss"]) / abs(w["ref_loss"])
    assert rel <= tc.LOSS_TOL, (got["loss"], w["ref_loss"])
    cmp = tc.compare(got, w["port"])
    assert cmp["loss"] <= tc.LOSS_TOL
    assert cmp["grad"][1] <= _tol(name), cmp["grad"]
    assert set(got["grads"]) == set(w["ref_grads"])
    for k, g in w["ref_grads"].items():
        top = np.abs(g).max()
        err = np.abs(got["grads"][k] - g).max()
        assert (err / top if top > 0 else err) <= _tol(name), k


@pytest.mark.parametrize("name", list(RUNS))
def test_every_leaf_has_a_gradient(trained, name):
    """Every leaf the meshless run gives a nonzero gradient has a
    nonzero one on the mesh (``value_and_grad`` raises on a missing one),
    and the first step's clipping binds."""
    res, want, _ = trained
    got, w = res[name][0], want[name]
    assert tc.compare(got, w["port"])["zero"] == []
    assert all(np.abs(g).max() > 0 for g in w["port"]["grads"].values())
    assert got["steps"][0][1] > CLIP


@pytest.mark.parametrize("name", list(RUNS))
def test_two_clipped_adamw_steps_equal_meshless(trained, name):
    """Each step's loss and gradient norm within 1e-5 and each leaf's
    update within 1e-3 relative in L2 of the meshless run's.  rwkv6 is
    held instead to its own fp32 conditioning: its mesh run is no farther
    from the meshless one than a 1e-7 relative nudge of the meshless
    run's weights moves it (which moves its second loss ~1e-4 and a
    ``tm/w0`` update ~5e-2, where granite's move ~1e-7 and ~4e-5)."""
    res, want, _ = trained
    cmp = tc.compare(res[name][0], want[name]["port"])
    steps, update = tc.LOSS_TOL, tc.UPDATE_TOL
    if name == "rwkv6_m2":
        nudged = want[name]["nudged"]
        steps, update = max(nudged["steps"]), nudged["update"][1]
    assert max(cmp["steps"]) <= steps, cmp["steps"]
    assert cmp["update"][1] <= update, cmp["update"]
    for r in res[name]:               # every rank took the same steps
        assert len(r["step_s"]) == 2


def test_moe_aux_loss_and_drops(trained):
    """olmoe at capacity factor 0.5 on ``data=2,model=2``: the aux loss
    (the routed fractions and mean probabilities of the whole batch,
    summed over ``data``) equals the reference's, and the pairs dropped
    on the ranks' rows, in rank order, the meshless run's (pairs drop)."""
    res, want, _ = trained
    w = want["olmoe_dm"]
    ranks = res["olmoe_dm"]
    for r in ranks:
        assert abs(r["aux"] - w["ref_aux"]) <= tc.LOSS_TOL * w["ref_aux"]
    assert sum(int(d.sum()) for d in w["drops"]) > 0
    rows = ranks[::2]                 # model coordinate 0, data order
    for i, d in enumerate(w["drops"]):
        np.testing.assert_array_equal(
            np.concatenate([r["drops"][i] for r in rows]), d)
    for r in ranks:
        assert r["bytes"][0].get(("ep", "all_reduce"), 0) > 0


def test_backward_bytes_by_scope(trained):
    """Every step moves the forward's FSDP gathers, the recompute's
    (``remat``) and the backward's reduce-scatters and gradient sums
    (``grad``); the FSDP gathers' reduce-scatter returns each rank's
    shard of every gathered byte."""
    res, _, _ = trained
    for r in res["granite_pod_b4"]:
        for b in r["bytes"]:
            fwd = b[("fsdp", "all_gather")]
            assert b[("remat", "all_gather")] > 0
            assert b[("grad", "all_reduce")] > 0
            # each all-gather's result is 4 shards, the reduce-scatter's
            # one; the embedding's int32 tokens (4 x 32) have no gradient
            assert 4 * b[("grad", "reduce_scatter")] + 4 * 32 * 4 == fwd


def test_generate_counts_no_backward_bytes(trained):
    """A ``generate`` (under ``no_grad``) on a trained sharded model
    counts no ``grad`` or ``remat`` bytes: serving costs what it did."""
    res, _, _ = trained
    for r in res["granite_dm_b3"]:
        scopes = r["generate_bytes"]
        assert "fsdp" in scopes
        assert not scopes & {"grad", "remat"}


def test_launcher_host_mesh(trained):
    """``--host-mesh 2x2`` under four ranks: rank 0 alone prints (the mesh
    line, the reference's step lines, the report); the last loss equals
    the meshless launcher's."""
    res, want, _ = trained
    out = [r[1] for r in res["extra"]]
    text, losses = out[0]
    assert text.startswith("# mesh {'data': 2, 'model': 2} over 4 ranks "
                           "(gloo, cpu)")
    assert "step     0 loss" in text and "tok/s on cpu" in text
    assert all(t == "" for t, _ in out[1:])
    got, ref = losses[-1], want["launch"].losses[-1]
    assert len(losses) == 3 and abs(got - ref) <= tc.LOSS_TOL * abs(ref)
    for _, ls in out[1:]:
        assert ls == losses


def test_launcher_save_on_a_mesh_writes_the_meshless_file(trained):
    _, _, files = trained
    init = ckpt.to_flat(build_model(get_config("granite-3-2b").smoke(),
                                    "cpu", seed=0))
    with np.load(files["mesh"]) as m, np.load(files["flat"]) as f:
        assert set(m.files) == set(f.files) == set(init)
        for k in f.files:
            assert m[k].shape == f[k].shape
            w = f[k] - init[k]
            err = np.linalg.norm(m[k] - init[k] - w)
            assert err <= tc.UPDATE_TOL * np.linalg.norm(w), k


def test_restore_then_shard_resumes(trained):
    """A sharded state saved by rank 0 holds the meshless state's keys
    and shapes (its parameters' updates within 1e-3), and restored then
    sharded it takes the same next step as the state in memory and as
    the meshless run."""
    res, want, files = trained
    init, flat1, (loss, gnorm) = want["resume"]
    with np.load(files["state"]) as s:
        assert set(s.files) == set(flat1)
        for k in s.files:
            assert s[k].shape == flat1[k].shape, k
        for k in init:
            w = flat1["params/" + k] - init[k]
            err = np.linalg.norm(s["params/" + k] - init[k] - w)
            assert err <= tc.UPDATE_TOL * np.linalg.norm(w), k
    for r, _ in res["extra"]:
        resumed, memory = r["steps"]
        assert resumed == memory
        assert abs(resumed[0] - loss) <= tc.LOSS_TOL * loss
        assert abs(resumed[1] - gnorm) <= tc.LOSS_TOL * gnorm


def test_save_on_a_mesh_keeps_no_arrays_on_other_ranks(trained):
    """``save`` of a sharded state copies every whole leaf to host memory
    on the mesh's first rank only: the other ranks take part in the
    gathers and drop what arrives."""
    res, want, _ = trained
    copies = [r["host_copies"] for r, _ in res["extra"]]
    # every key of the meshless state at least once (a stacked leaf
    # once a layer)
    assert copies[0] >= len(want["resume"][1]) > 0
    assert copies[1:] == [0, 0, 0]


def test_flop_share_counts_the_cards_a_mesh_occupies(capsys):
    """The launcher's model-FLOP share divides by the peak of every card
    the mesh's ranks occupy, and its report names the peak as rank 0's."""
    run = port_train.TrainRun(state=None, step_s=[2.0, 1.0], losses=[],
                              grad_norms=[], tokens_per_step=1000,
                              n_params=10 ** 9, peak_gib=1.0,
                              device="cuda")
    four = run._replace(cards=4)
    assert four.flop_share() * 4 == pytest.approx(run.flop_share())
    port_train._report(four, get_config("granite-3-2b"), mesh=True)
    line = capsys.readouterr().out
    assert "peak 1.00 GiB on rank 0" in line
    assert f"share {four.flop_share():.4f} of 4 x 989 TFLOP/s" in line


def test_launcher_joins_the_group_from_its_environment():
    """``--host-mesh 1x1`` in one process joins the default group the way
    a ``torchrun`` rank does (``init_distributed`` with no rank or world
    size given) and trains as the meshless launcher does."""
    argv = ["--device", "cpu", "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "32"]
    mesh = port_train.main(argv + ["--host-mesh", "1x1"])
    flat = port_train.main(argv)
    assert mesh.losses == flat.losses
