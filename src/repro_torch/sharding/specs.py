"""Sharding rules: parameter path -> placement (counterpart of
``repro/sharding/specs.py``).

Scheme, as the reference's: tensor parallelism over ``model`` on the head,
FFN, expert and vocab axes; FSDP over ``(pod, data)`` on the embed axis;
activations batch-sharded over ``(pod, data)``; long-context decode (batch
1) shards the KV cache's sequence axis over ``data`` instead.

A placement is a tuple with one entry per tensor dimension: a mesh axis
name, a tuple of axis names, or None (that dimension is replicated); the
empty tuple means "replicated", as the reference's ``P()``.  The functions
work on shapes alone: a tree is a dict of flat '/'-joined paths (the
reference's keys, ``training/checkpoint.py::leaf_map``) to shapes, or a
``Model`` (a ``meta``-device one will do), whose stacked layer leaves get
the reference's leading ``(repeats, ...)`` axis (``tree_shapes``).  A
mesh is a ``torch.distributed`` ``DeviceMesh`` or anything with a
``shape`` mapping of axis sizes (the reference tests' ``FakeMesh``).

At run time ``training/checkpoint.py::shard`` applies every placement of
a model of any of the reference's block kinds, whisper's encoder and
internvl2's projector among them: the ``model`` entries, then the FSDP
entries (the embed axis over ``(pod, data)``); the serving engine places
batch rows, pool blocks and a batch-1 cache's sequence as ``batch_spec``
and ``cache_specs`` say (an MLA latent over the FSDP axes or ``data``,
never ``model``; a sliding window's ring like any KV cache; a recurrent
state, which has no sequence axis, whole on every ``data`` rank at batch
1; whisper's cross-attention keys and values ``cross/{k,v}`` (R, b,
n_ctx, n_kv, hd) by the ``/(k|v)$`` rule they meet first, so at batch 1
their encoder frames split over ``data``).  One placement differs:
``cache_specs``
cuts a Mamba2 convolution tail's concatenated ``[x | B | C]`` channels
at their midpoint, while the port's tail holds the rank's x channels and
the whole B and C channels (``models/mamba2.py``).
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig

Spec = Tuple          # one entry per dimension: axis name, tuple, or None


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (in its axis order) or of an
    object with a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(mesh.size(i)) for i, n in enumerate(names)}
    return dict(mesh.shape)


def fsdp_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _rules(F):
    """(regex on path suffix, spec): the first match wins.  F = FSDP axes."""
    M = "model"
    return [
        # embeddings / readout (vocab over model, embed over FSDP)
        (r"embed/emb$",                 (M, F)),
        (r"lm_head/w$",                 (F, M)),
        # attention projections
        (r"(wq|wk|wv|wg|xq|xk|xv)/w$",  (F, M)),
        (r"(wo|xo)/w$",                 (M, F)),
        # MLA
        (r"wq_a/w$",                    (F, None)),
        (r"wq_b/w$",                    (None, M)),
        (r"wkv_a/w$",                   (F, None)),
        (r"(wk_b|wv_b)$",               (None, M, None)),
        # dense MLP
        (r"mlp/(gate|up)/w$",           (F, M)),
        (r"mlp/down/w$",                (M, F)),
        (r"shared/(gate|up)/w$",        (F, M)),   # deepseek shared experts
        (r"shared/down/w$",             (M, F)),
        # MoE (expert-parallel over model)
        (r"moe/router/w$",              (F, None)),
        (r"moe/(gate|up)$",             (M, F, None)),
        (r"moe/down$",                  (M, None, F)),
        # RWKV6
        (r"tm/(wa)$",                   (F, None)),
        (r"tm/(wb)$",                   (None, M)),
        (r"tm/(w0)$",                   (M,)),
        (r"tm/u$",                      (M, None)),
        (r"tm/mu$",                     (None, None)),
        (r"cm/wk/w$",                   (F, M)),
        (r"cm/wv/w$",                   (M, F)),
        (r"cm/wr/w$",                   (F, M)),
        # Mamba2 (x/z/dt head-aligned over model; B/C replicated)
        (r"(z_proj|x_proj)/w$",         (F, M)),
        (r"bc_proj/w$",                 (F, None)),
        (r"dt_proj/w$",                 (F, M)),
        (r"conv_x_w$",                  (None, M)),
        (r"conv_x_b$",                  (M,)),
        (r"conv_bc_(w|b)$",             (None,)),
        (r"(a_log|d_skip|dt_bias)$",    (M,)),
        (r"mamba/norm/g$",              (M,)),
        (r"out_proj/w$",                (M, F)),
        # VLM projector
        (r"proj/fc\d/w$",               (F, None)),
        # MTP mixer
        (r"mtp/mix/w$",                 (F, None)),
        # norms, biases, everything small: replicated
        (r".*",                         None),
    ]


_HEAD_SENSITIVE = re.compile(r"(wq|wg|xq|wo|xo)/w$|wq_b/w$|(wk_b|wv_b)$")
_KV_SENSITIVE = re.compile(r"(wk|wv|xk|xv)/w$")


def tree_shapes(tree) -> Dict[str, Tuple[int, ...]]:
    """A dict of path -> shape as given, or a ``Model``'s parameters under
    the reference's flat keys, stacked leaves with their leading repeats
    axis."""
    if isinstance(tree, dict):
        return {k: tuple(v if isinstance(v, tuple) else v.shape)
                for k, v in tree.items()}
    from repro_torch.training.checkpoint import leaf_map
    return {k: ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
            for k, (ts, stacked) in leaf_map(tree).items()}


def param_specs(cfg: ModelConfig, params_tree, mesh) -> Dict[str, Spec]:
    """Placement of every parameter (a dict keyed like ``tree_shapes``).

    Head-count semantics: a fused (d, n_heads * head_dim) projection
    shards over ``model`` only when the HEAD count divides the axis;
    otherwise the split would cut through a head (whisper 12H, internvl
    14H, granite kv=8 on a 16-way model axis).  An axis that does not
    divide its dimension is dropped too."""
    F = fsdp_axes(mesh)
    msize = mesh_shape(mesh).get("model", 1)
    head_ok = cfg.n_heads % msize == 0
    kv_ok = cfg.n_kv_heads % msize == 0
    rules = [(re.compile(pat), spec) for pat, spec in _rules(F)]

    def assign(s, shape):
        ndim = len(shape)
        drop_model = ((_KV_SENSITIVE.search(s) and not kv_ok)
                      or (_HEAD_SENSITIVE.search(s) and not head_ok))
        for pat, spec in rules:
            if not pat.search(s):
                continue
            if spec is None:
                return ()
            if drop_model:
                spec = tuple(None if ax == "model" else ax for ax in spec)
            if len(spec) > ndim:            # rule broader than the leaf
                spec = spec[-ndim:]
            if len(spec) < ndim:            # stacked repeats axis etc.
                spec = (None,) * (ndim - len(spec)) + spec
            return tuple(ax if (ax is not None
                                and dim % _axes_size(mesh, ax) == 0
                                and dim >= _axes_size(mesh, ax)) else None
                         for dim, ax in zip(shape, spec))
        return ()

    return {s: assign(s, shp) for s, shp in tree_shapes(params_tree).items()}


def _axes_size(mesh, ax) -> int:
    if ax is None:
        return 1
    shape = mesh_shape(mesh)
    names = ax if isinstance(ax, tuple) else (ax,)
    # an axis the mesh lacks has size 1 (the reference's raises there)
    return int(math.prod(shape.get(a, 1) for a in names))


def _maybe(mesh, dim: int, ax):
    """ax if it divides dim, else None."""
    return ax if (ax is not None and dim % _axes_size(mesh, ax) == 0) \
        else None


def batch_spec(cfg: ModelConfig, batch_tree, mesh) -> Dict[str, Spec]:
    """Input placements: the batch axis over (pod, data); the rest
    follows."""
    F = fsdp_axes(mesh)

    def assign(shape):
        b = shape[0] if shape else 0
        return (_maybe(mesh, b, F),) + (None,) * (len(shape) - 1)

    return {k: assign(s) for k, s in tree_shapes(batch_tree).items()}


def cache_specs(cfg: ModelConfig, cache_tree, mesh,
                paged: bool = False) -> Dict[str, Spec]:
    """KV / state cache placements, on the reference's cache leaves
    (``stacks/<s>/<j>/kv/k`` (R, b, cap, n_kv, hd), ``.../pos`` (R, b,
    cap), ...; ``kv_cache_shapes`` gives them).

    batch >= |pod * data|: batch over the FSDP axes, heads over model.
    batch == 1 (long context): the sequence axis over ``data`` and heads
    over ``model``.  ``paged=True`` is the paged pool, whose batch axis is
    the physical block axis (over the FSDP axes) and whose capacity axis
    is the within-block slot axis, never sequence-sharded."""
    F = fsdp_axes(mesh)
    M = "model"

    def assign(s, shp):
        nd = len(shp)
        if nd == 0:
            return ()
        batch_ax = _maybe(mesh, shp[1] if nd > 1 else 0, F)   # after repeats

        def seq_ax(dim):
            if paged or batch_ax is not None:
                return None
            return _maybe(mesh, dim, "data")

        if re.search(r"/(k|v)$", s) and nd == 5:       # (R, b, cap, n_kv, hd)
            return (None, batch_ax, seq_ax(shp[2]), _maybe(mesh, shp[3], M),
                    None)
        if re.search(r"/pos$", s) and nd == 3:          # (R, b, cap)
            return (None, batch_ax, seq_ax(shp[2]))
        if re.search(r"/(ckv|krope)$", s) and nd == 4:  # (R, b, cap, r)
            return (None, batch_ax, seq_ax(shp[2]), None)
        if re.search(r"/ssd$", s) and nd == 5:          # (R, b, H, P, N)
            return (None, batch_ax, _maybe(mesh, shp[2], M), None, None)
        if re.search(r"/conv$", s) and nd == 4:         # (R, b, K-1, ch)
            return (None, batch_ax, None, _maybe(mesh, shp[3], M))
        if re.search(r"/wkv$", s) and nd == 5:          # (R, b, H, D, D)
            return (None, batch_ax, _maybe(mesh, shp[2], M), None, None)
        if re.search(r"/(shift_tm|shift_cm)$", s) and nd == 3:
            return (None, batch_ax, None)
        # (whisper's ``cross/{k,v}`` (R, b, n_ctx, kv, hd) meet the
        # ``/(k|v)$`` rule first, as in the reference, whose cross rule
        # comes after it)
        if nd >= 2:
            return (None, batch_ax) + (None,) * (nd - 2)
        return ()

    return {s: assign(s, shp) for s, shp in tree_shapes(cache_tree).items()}


def kv_cache_shapes(cfg: ModelConfig, batch: int, cap: int,
                    n_kv: Optional[int] = None) -> Dict[str, Tuple]:
    """The reference's cache leaves of a model (every stack's, stacked
    over repeats) for a (batch, cap) cache: what ``cache_specs`` reads to
    place the port's caches.  An attention layer's ``kv/{k,v,pos}`` (a
    windowed layer's ring at ``min(cap, window)`` slots), an MLA layer's
    ``latent/{ckv,krope,pos}``, a Mamba2 layer's ``mamba/conv`` (b, K - 1,
    x + B + C channels) and ``mamba/ssd`` (b, H, P, N) (zamba2's shared
    block adds its own ``kv/*``), an RWKV6 layer's ``rwkv/{shift_tm,
    shift_cm}`` (b, d) and ``rwkv/wkv`` (b, H, D, D), a whisper
    ``dec_cross`` layer's self-attention ``kv/*`` beside its
    ``cross/{k,v}`` (b, ``encoder.n_ctx``, n_kv, hd)."""
    n_kv = cfg.n_kv_heads if n_kv is None else n_kv
    hd = cfg.resolved_head_dim
    out = {}
    for si, (period, reps) in enumerate(cfg.stacks()):
        for j, kind in enumerate(period):
            pre = f"stacks/{si}/{j}/"
            if kind in ("mla", "mla_moe"):
                m = cfg.mla
                out[pre + "latent/ckv"] = (reps, batch, cap, m.kv_lora_rank)
                out[pre + "latent/krope"] = (reps, batch, cap, m.qk_rope_dim)
                out[pre + "latent/pos"] = (reps, batch, cap)
                continue
            if kind in ("mamba", "mamba_shared_attn"):
                s = cfg.ssm
                di = s.expand * cfg.d_model
                out[pre + "mamba/conv"] = (reps, batch, s.d_conv - 1,
                                           di + 2 * s.d_state)
                out[pre + "mamba/ssd"] = (reps, batch, di // s.head_dim,
                                          s.head_dim, s.d_state)
                if kind == "mamba":
                    continue
            elif kind == "rwkv":
                d, rd = cfg.d_model, cfg.rwkv.head_dim
                out[pre + "rwkv/shift_tm"] = (reps, batch, d)
                out[pre + "rwkv/shift_cm"] = (reps, batch, d)
                out[pre + "rwkv/wkv"] = (reps, batch, d // rd, rd, rd)
                continue
            elif kind == "dec_cross":
                out[pre + "cross/k"] = out[pre + "cross/v"] = (
                    reps, batch, cfg.encoder.n_ctx, n_kv, hd)
            elif kind not in ("attn", "attn_moe", "attn_local"):
                raise ValueError(f"block kind {kind!r} has no cache")
            ring = min(cap, cfg.sliding_window) if kind == "attn_local" \
                else cap
            out[pre + "kv/k"] = out[pre + "kv/v"] = (reps, batch, ring, n_kv,
                                                     hd)
            out[pre + "kv/pos"] = (reps, batch, ring)
    return out


def payload_specs(place: Dict[str, Spec]) -> Dict[str, Spec]:
    """The placements of each layer's payload leaf (``kv/k`` or
    ``latent/ckv``) of a ``cache_specs`` result, by its layer prefix
    ``stacks/<s>/<j>``."""
    return {k.rsplit("/", 2)[0]: v for k, v in place.items()
            if k.endswith(("/kv/k", "/latent/ckv"))}


def model_axis_entry(spec: Spec) -> Optional[int]:
    """The dimension a placement shards over ``model``, or None."""
    for i, ax in enumerate(spec):
        if ax == "model" or (isinstance(ax, tuple) and "model" in ax):
            return i
    return None


def fsdp_axis_entry(spec: Spec) -> Optional[int]:
    """The dimension a placement shards over the FSDP axes (``pod``,
    ``data`` or both), or None."""
    for i, ax in enumerate(spec):
        names = ax if isinstance(ax, tuple) else (ax,)
        if any(a in ("pod", "data") for a in names):
            return i
    return None
