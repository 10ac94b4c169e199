"""Checkpoints and the weight bridge to the reference's parameters
(counterpart of ``repro/training/checkpoint.py``).

The reference flattens its parameter pytree to '/'-joined key paths
(``embed/emb``, ``ln_f/g``, ``stacks/<stack>/<period position>/wq/w``, ...)
and saves them with ``np.savez``.  Stacked layer leaves carry a leading
``(repeats, ...)`` axis; row ``r`` of period position ``j`` is the port's
layer ``r * len(period) + j`` of that stack.  Each linear weight is stored
once in the compute dtype; the embedding, an untied ``lm_head`` and the
norm gains stay fp32.  MoE blocks add ``moe/router/w``, the expert stacks
``moe/gate``, ``moe/up``, ``moe/down`` and ``moe/shared/*``; MLA blocks
``wq_a/w``, ``q_ln/g``, ``wq_b/w``, ``wkv_a/w``, ``kv_ln/g``, ``wk_b``,
``wv_b``; an MTP model ``mtp/block/*`` (one unstacked block), ``mtp/ln/g``
and ``mtp/mix/w``.  Mamba2 blocks hold ``ln/g`` and ``mamba/*`` (the
projections' ``*/w``, the split convolution's weights and biases,
``a_log``, ``d_skip``, ``dt_bias``, ``norm/g``), zamba2's one shared
attention block the top-level ``shared/*`` (unstacked), and RWKV6 blocks
``ln1/g``, ``ln2/g``, ``tm/*`` and ``cm/*`` (the shift mixes ``mu``, the
decay ``w0`` / ``wa`` / ``wb``, the bonus ``u``).  Whisper's LayerNorms add
a bias ``*/b`` beside each gain; its decoder blocks hold the
self-attention block under ``self/*`` and ``ln_x/{g,b}``,
``x{q,k,v,o}/w``, its encoder ``enc/stack/0/*`` (one period position,
stacked over the encoder's layers) and ``enc/ln/g``; internvl2's
projector ``proj/fc{1,2}/{w,b}``.
``load_score_projection`` bridges the one array that is not a parameter:
the cached low-rank scoring projection.

``leaf_map`` is that key map, every parameter of the model under its key;
``from_flat`` reads a flat dict through it and ``to_flat`` writes one
(layers re-stacked on the leading axis), which ``save`` puts in an npz
the reference's ``restore`` reads: a model's parameters, or a training
state under the reference's ``TrainState`` keys ``params/...``,
``opt/step``, ``opt/mu/...``, ``opt/nu/...``.  A bf16 leaf is saved as
fp32 (numpy has no bf16; the reference's leaves are fp32 anyway).  The
map also gives each parameter the rank of its reference leaf
(``leaf_ranks``), on which the reference's AdamW decides weight decay.

``shard(model, mesh)`` slices every leaf, in place, by its placement
(``sharding/specs.py::param_specs`` on these keys; a stacked leaf's
placement without its leading repeats entry) to this rank's share: its
``model`` entry by the rank's ``model`` coordinate, then its FSDP entry
(the embed axis) by the rank's coordinate on the flattened ``(pod,
data)`` group, and hands the blocks and the model their layout (zamba2's
shared block once: its leaves are the top-level ``shared/*``; whisper's
encoder layers as any attention block; internvl2's projector, whose
weights only FSDP cuts, gathers them per call, ``Model.project``);
``from_flat(..., mesh=)`` shards what it reads.  A model is drawn whole
(``Model.init``) on every rank before it is sliced, so every rank and a
meshless run hold the same weights.  ``shard`` records each parameter's
cut dimensions (``Model.cuts``), which the trainer reads (a leaf the
mesh replicates over an axis has its gradient summed over it, and the
gradient norm counts each element once: ``leaf_axes``), and slices an
optimizer state's moments with their parameters (``state=``): so
``restore_state`` followed by ``shard`` resumes training on a mesh.  On
a sharded model ``to_flat``, ``state_flat`` and ``save`` gather every
leaf back to the reference's whole shape (every rank calls them: the
gathers are collectives); only the mesh's first rank copies each whole
leaf to host memory, the others drop it as it arrives, and the first
rank writes the file, the one a meshless run writes.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.blocks import (DecCrossBlock, MambaBlock, MLABlock,
                                      RWKVBlock)
from repro_torch.models.model import Model
from repro_torch.sharding import comm, specs
from repro_torch.training import optimizer as opt


def _module_leaves(prefix: str, mod, linears) -> Dict[str, torch.Tensor]:
    """A recurrent mixer's parameters: ``linears`` as ``<name>/w``, a norm
    gain as ``norm/g``, the rest bare."""
    return {f"{prefix}/{n}/w" if n in linears else
            f"{prefix}/{n}/g" if n == "norm" else f"{prefix}/{n}": p
            for n, p in mod.named_parameters()}


def _block_leaves(blk) -> Dict[str, torch.Tensor]:
    """A block's parameters under the reference's key suffixes."""
    if isinstance(blk, MambaBlock):
        return {"ln/g": blk.ln, **_module_leaves("mamba", blk.mamba,
                                                 mamba2.LINEARS)}
    if isinstance(blk, RWKVBlock):
        return {"ln1/g": blk.ln1, "ln2/g": blk.ln2,
                **_module_leaves("tm", blk.tm, rwkv6.TM_LINEARS),
                **_module_leaves("cm", blk.cm, rwkv6.CM_LINEARS)}
    if isinstance(blk, DecCrossBlock):
        return {**{f"self/{k}": p
                   for k, p in _block_leaves(blk.self_attn).items()},
                **_norm_leaves(blk, "ln_x"), "xq/w": blk.xq, "xk/w": blk.xk,
                "xv/w": blk.xv, "xo/w": blk.xo}
    out = {**_norm_leaves(blk, "ln1"), **_norm_leaves(blk, "ln2"),
           "wo/w": blk.wo}
    if isinstance(blk, MLABlock):
        out.update({"wq_a/w": blk.wq_a, "q_ln/g": blk.q_ln,
                    "wq_b/w": blk.wq_b, "wkv_a/w": blk.wkv_a,
                    "kv_ln/g": blk.kv_ln, "wk_b": blk.wk_b,
                    "wv_b": blk.wv_b})
    else:
        out.update({"wq/w": blk.wq, "wk/w": blk.wk, "wv/w": blk.wv})
    if hasattr(blk, "moe"):
        out.update({"moe/router/w": blk.moe.router, "moe/gate": blk.moe.gate,
                    "moe/up": blk.moe.up, "moe/down": blk.moe.down})
        out.update({f"moe/shared/{k}/w": p
                    for k, p in blk.moe.shared.items()})
    else:
        out.update({f"mlp/{k}/w": p for k, p in blk.mlp.items()})
    return out


def _norm_leaves(blk, name) -> Dict[str, torch.Tensor]:
    """A block norm's gain ``<name>/g`` and, for a LayerNorm, its bias
    ``<name>/b``."""
    out = {f"{name}/g": getattr(blk, name)}
    if hasattr(blk, name + "_b"):
        out[f"{name}/b"] = getattr(blk, name + "_b")
    return out


def leaf_map(model: Model) -> Dict[str, Tuple[List[torch.Tensor], bool]]:
    """Every parameter of ``model`` under the reference's flat key:
    ``key -> (tensors, stacked)``.  A top-level leaf is one tensor; a
    stacked leaf ``<stack>/<period position>/<suffix>`` lists its layers'
    tensors in repeat order (the reference's leading ``(repeats, ...)``
    axis)."""
    top = {"embed/emb": model.embed, "ln_f/g": model.ln_f}
    if model.lm_head is not None:
        top["lm_head/w"] = model.lm_head
    if model.mtp is not None:
        top.update({f"mtp/block/{k}": p
                    for k, p in _block_leaves(model.mtp.block).items()})
        top.update({"mtp/ln/g": model.mtp.ln, "mtp/mix/w": model.mtp.mix})
    if model.shared is not None:
        top.update({f"shared/{k}": p
                    for k, p in _block_leaves(model.shared).items()})
    if model.enc is not None:
        top["enc/ln/g"] = model.enc_ln
    if model.proj is not None:
        top.update({f"proj/{k.replace('_', '/')}": p
                    for k, p in model.proj.items()})
    out = {k: ([p], False) for k, p in top.items()}
    stacks = [(f"stacks/{si}", s) for si, s in enumerate(model.stacks)]
    if model.enc is not None:
        stacks.append(("enc/stack", model.enc))
    for prefix, stack in stacks:
        n_period = len(stack.period)
        for j in range(n_period):
            rows = [_block_leaves(stack.layers[r * n_period + j])
                    for r in range(stack.repeats)]
            for suffix in rows[0]:
                out[f"{prefix}/{j}/{suffix}"] = ([row[suffix] for row in rows],
                                                 True)
    return out


def leaf_ranks(model: Model) -> List[int]:
    """The rank of each parameter's reference leaf, in
    ``model.parameters()`` order: the tensor's own, plus one inside a
    stack (the reference's ``(repeats, ...)`` axis)."""
    rank = {}
    for ts, stacked in leaf_map(model).values():
        for t in ts:
            rank[t] = t.ndim + int(stacked)
    return [rank[p] for p in model.parameters()]


def _copy(param: torch.Tensor, arr: np.ndarray, key: str) -> None:
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{key}: shape {arr.shape} != {tuple(param.shape)}")
    param.copy_(torch.from_numpy(np.array(arr)))


#: the block kinds a mesh places (whisper's encoder layers are
#: ``enc_attn``)
MESH_KINDS = ("attn", "attn_local", "attn_moe", "mla", "mla_moe", "mamba",
              "mamba_shared_attn", "rwkv", "dec_cross", "enc_attn")


def check_mesh(cfg: ModelConfig, mesh) -> None:
    """Raise for a block kind ``shard`` does not place (one outside
    ``MESH_KINDS``)."""
    kinds = set(cfg.layer_kinds()) | ({"enc_attn"} if cfg.encoder else set())
    bad = sorted(kinds - set(MESH_KINDS))
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad} are not placed on a mesh "
            f"({', '.join(map(repr, MESH_KINDS))} only)")


@torch.no_grad()
def shard(model: Model, mesh, state: opt.OptState = None) -> Model:
    """Slice ``model``'s weights, in place, to this rank's share of the
    mesh's ``model`` axis (module docstring) and place its blocks; the
    moments of an optimizer ``state`` of the meshless model (its lists,
    in ``model.parameters()`` order) are sliced with their parameters.  A
    model already sharded on ``mesh`` is returned as it is."""
    if model.mesh is mesh:
        return model
    if model.mesh is not None:
        raise ValueError("the model is already sharded on another mesh")
    cfg = model.cfg
    check_mesh(cfg, mesh)
    ax = comm.axis(mesh, "model")
    fax = comm.axis(mesh, specs.fsdp_axes(mesh) or ())
    leaves = leaf_map(model)
    placements = specs.param_specs(cfg, specs.tree_shapes(model), mesh)
    index = {p: i for i, p in enumerate(model.parameters())}
    moments = [] if state is None else [state.mu, state.nu]
    model.cuts = {}
    for key, (ts, stacked) in leaves.items():
        spec = placements[key][int(stacked):]
        cut = [dim if dim is not None and a.size > 1 else None
               for dim, a in ((specs.model_axis_entry(spec), ax),
                              (specs.fsdp_axis_entry(spec), fax))]
        for t in ts:
            model.cuts[t] = tuple(cut)
        for dim, a in zip(cut, (ax, fax)):
            if dim is None:
                continue
            for t in ts:
                n = t.shape[dim] // a.size
                t.data = t.data.narrow(dim, a.rank * n, n).clone()
                for ms in moments:
                    i = index[t]
                    ms[i] = ms[i].narrow(dim, a.rank * n, n).clone()
    if model.shared is not None:        # zamba2's one shared block, once
        model.shared.place(ax, fax)
    enc = list(model.enc.layers) if model.enc is not None else []
    for blk in model.layers() + enc + ([model.mtp.block] if model.mtp
                                       else []):
        if isinstance(blk, MambaBlock):
            blk.place(ax, fax, shared=model.shared)
        else:
            blk.place(ax, fax)
    if model.embed.shape[0] < cfg.vocab:
        model.tp_vocab = ax
    if fax.size > 1:
        model.fsdp = fax
    model.mesh = mesh
    return model


@torch.no_grad()
def from_flat(flat: Dict[str, np.ndarray], cfg: ModelConfig,
              device=None, mesh=None) -> Model:
    """Build the port's model from the reference's flat parameter dict
    (sharded on ``mesh`` when one is given)."""
    model = Model(cfg, device)
    leaves = leaf_map(model)
    missing = set(leaves) - set(flat)
    if missing:
        raise ValueError(f"checkpoint lacks parameters: {sorted(missing)}")
    for key, (ts, stacked) in leaves.items():
        arr = flat[key]
        if not stacked:
            _copy(ts[0], arr, key)
            continue
        if arr.shape[0] != len(ts):
            raise ValueError(f"{key}: {arr.shape[0]} repeats, "
                             f"expected {len(ts)}")
        for t, row in zip(ts, arr):
            _copy(t, row, key)
    extra = set(flat) - set(leaves)
    if extra:
        raise ValueError(f"checkpoint has parameters the port does not "
                         f"hold: {sorted(extra)}")
    return model if mesh is None else shard(model, mesh)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` (on the CPU ``numpy()`` alone would share
    the tensor's memory, which a training step then updates)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


def leaf_axes(model: Model) -> List[Tuple[str, ...]]:
    """For each parameter, in ``model.parameters()`` order, the mesh axes
    that cut it (``"model"``, ``"fsdp"``: the flattened ``(pod, data)``
    group); () for a leaf every rank holds whole, and for every leaf of a
    meshless model."""
    cuts = getattr(model, "cuts", None) or {}
    return [tuple(name for name, dim in zip(("model", "fsdp"),
                                            cuts.get(p, (None, None)))
                  if dim is not None) for p in model.parameters()]


def _whole(model: Model, param, t: torch.Tensor) -> torch.Tensor:
    """``t`` (``param``'s shard, or a tensor cut as it is) gathered to the
    whole leaf over the axes that cut ``param``: the FSDP axis first,
    then ``model`` (the reverse of ``shard``'s slicing)."""
    cuts = getattr(model, "cuts", None)
    if not cuts:
        return t
    mdim, fdim = cuts[param]
    if fdim is not None:
        t = comm.all_gather(t.contiguous(), model.fsdp, fdim)
    if mdim is not None:
        t = comm.all_gather(t.contiguous(), comm.axis(model.mesh), mdim)
    return t


@torch.no_grad()
def to_flat(model: Model, pick: Callable = None) -> Dict[str, np.ndarray]:
    """The inverse of ``from_flat``: the reference's flat dict of numpy
    arrays.  ``pick(param)`` chooses the tensor saved for each parameter
    (default the parameter itself; e.g. its gradient or its moment).  On
    a sharded model every rank calls it: each leaf is gathered whole, and
    only the mesh's first rank keeps it (the others return {})."""
    pick = pick or (lambda p: p)
    keep = _first(model)
    out = {}
    for key, (ts, stacked) in leaf_map(model).items():
        arrs = []
        for t in ts:
            w = _whole(model, t, pick(t))
            if keep:
                arrs.append(_numpy(w))
            del w
        if keep:
            out[key] = np.stack(arrs) if stacked else arrs[0]
    return out


def _first(model: Model) -> bool:
    """Whether this process is the mesh's first rank (or meshless)."""
    return model.mesh is None or comm.seed(model.mesh) == 1.0


def _flat_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays or tensors as '/'-joined keys."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat_tree(v, key + "/"))
        else:
            out[key] = _numpy(v) if isinstance(v, torch.Tensor) \
                else np.asarray(v)
    return out


def state_flat(model: Model, ostate: opt.OptState) -> Dict[str, np.ndarray]:
    """A training state under the reference's ``TrainState`` keys ({} on
    a mesh's other ranks, as ``to_flat``)."""
    index = {p: i for i, p in enumerate(model.parameters())}
    out = {f"params/{k}": v for k, v in to_flat(model).items()}
    for name, moments in (("mu", ostate.mu), ("nu", ostate.nu)):
        out.update({f"opt/{name}/{k}": v for k, v in to_flat(
            model, lambda p: moments[index[p]]).items()})
    if _first(model):
        out["opt/step"] = _numpy(ostate.step)
    return out


def save(path: str, tree, meta: Dict = None) -> None:
    """Write ``tree`` with ``np.savez`` under the reference's keys, and
    ``meta`` (if given) as JSON to ``path + ".meta.json"``.  ``tree`` is a
    ``Model`` (its parameters), a ``TrainState`` (``training/loop.py``:
    its model's parameters and optimizer state) or a nested dict of
    arrays.  A sharded model's or state's leaves are gathered whole (each
    rank must call ``save``); the mesh's first rank alone keeps them and
    writes."""
    if isinstance(tree, Model):
        flat, first = to_flat(tree), _first(tree)
    elif isinstance(tree, dict):
        flat, first = _flat_tree(tree), True
    else:
        flat, first = state_flat(tree.model, tree.opt), _first(tree.model)
    if not first:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2)


def load_meta(path: str) -> Dict:
    with open(path + ".meta.json") as f:
        return json.load(f)


def load_score_projection(d: int, r: int, array: np.ndarray) -> None:
    """Install the reference's low-rank scoring projection (``np.asarray(
    repro.kernels.ops.score_projection(d, r))``) as the port's cached
    (d, r) projection, used by ``score_proj_dim`` and Loki on every
    device.  The reference draws it from ``jax.random``; this bridge is how
    both packages score with the same numbers."""
    kops.set_score_projection(d, r, torch.from_numpy(np.array(array)))


def _load(path: str) -> Dict[str, np.ndarray]:
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def restore(path: str, cfg: ModelConfig, device=None) -> Model:
    """A model from an npz of parameters (``save`` of a model, or the
    reference's ``save`` of its params)."""
    return from_flat(_load(path), cfg, device)


@torch.no_grad()
def restore_state(path: str, cfg: ModelConfig, device=None
                  ) -> Tuple[Model, opt.OptState]:
    """A model (trainable) and its optimizer state from a saved training
    state (the port's or the reference's ``TrainState``), each moment in
    its parameter's dtype.  ``TrainState(*restore_state(...))`` resumes;
    on a mesh, ``shard(model, mesh, state=ostate)`` first."""
    flat = _load(path)
    model = from_flat({k[len("params/"):]: v for k, v in flat.items()
                       if k.startswith("params/")}, cfg, device)
    index = {p: i for i, p in enumerate(model.parameters())}
    moments = {"mu": [None] * len(index), "nu": [None] * len(index)}
    for key, (ts, stacked) in leaf_map(model).items():
        for name, out in moments.items():
            arr = flat[f"opt/{name}/{key}"]
            for t, row in zip(ts, arr if stacked else [arr]):
                out[index[t]] = torch.tensor(row, dtype=t.dtype,
                                             device=t.device)
    step = torch.as_tensor(flat["opt/step"], dtype=torch.int32,
                           device=model.device)
    model.requires_grad_(True)
    return model, opt.OptState(step=step, mu=moments["mu"],
                               nu=moments["nu"])
