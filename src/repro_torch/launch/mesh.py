"""Mesh builders (counterpart of ``repro/launch/mesh.py``): functions, not
module constants, so importing this module never touches the process
group.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with axes named from
``(pod, data, model)``, one process per rank (launch with ``torchrun``,
or join a group with ``init_distributed``).  It lives on the card unless
the caller asks for the CPU.  The process group's backend:

  * NCCL when every rank has a card of its own (rank ``r`` on card
    ``LOCAL_RANK``);
  * gloo when the ranks share one card (all on the current card) or run
    on the CPU.

``make_host_mesh`` is the CPU mesh of the tests (gloo), as the
reference's is for its host-device tests.
"""
from __future__ import annotations

import math
import os
import tempfile
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

AXES = ("pod", "data", "model")


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """'data=2,model=4' -> {"data": 2, "model": 4} (axis order preserved)."""
    out = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        name, size = name.strip(), size.strip()
        if name not in AXES or not size.isdigit():
            raise ValueError(
                f"bad mesh spec {spec!r}: expected e.g. 'data=2,model=4' "
                f"with axes from (pod, data, model)")
        out[name] = int(size)
    return out


def choose_backend(device: torch.device, world_size: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_distributed(device=None, *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the default process group (from ``torchrun``'s environment
    unless ``init_method`` / ``rank`` / ``world_size`` are given) with the
    backend ``choose_backend`` picks, and return this rank's device: its
    own card under NCCL, the shared current card under gloo, or the CPU.
    Already joined: only the device is returned."""
    from repro_torch.models.model import resolve_device
    dev = resolve_device(device)
    if not dist.is_initialized():
        rank = int(os.environ.get("RANK", 0)) if rank is None else rank
        world_size = n_ranks() if world_size is None else world_size
        if init_method is None:
            # one rank outside torchrun: a private file rendezvous
            init_method = "env://" if "MASTER_ADDR" in os.environ else \
                "file://" + tempfile.mkdtemp() + "/rendezvous"
        backend = choose_backend(dev, world_size)
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size)
    if dev.type == "cuda" and dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _device_mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def n_ranks() -> int:
    """The world size: the joined group's, else ``torchrun``'s, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def _need(n: int, spec: str) -> None:
    have = n_ranks()
    if n != have:
        raise ValueError(
            f"mesh {spec!r} needs {n} devices but {have} are visible "
            f"(launch {n} ranks: torchrun --nproc-per-node {n} ...)")


def make_host_mesh(model: int = 1, data: int = 1):
    """Small CPU mesh (gloo) for the tests: ``data * model`` ranks must
    have joined the default group."""
    _need(data * model, f"data={data},model={model}")
    return _device_mesh("cpu", (data, model), ("data", "model"))


def mesh_from_spec(spec: str, device=None):
    """A mesh from a ``--mesh data=N,model=M`` flag value, on the card
    unless ``device`` names the CPU; joins the default group from
    ``torchrun``'s environment if this process has not.  The axis product
    must equal the world size."""
    axes = parse_mesh_spec(spec)
    _need(math.prod(axes.values()), spec)
    dev = init_distributed(device)
    return _device_mesh(dev.type, axes.values(), axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production shapes: (data=16, model=16), 256 ranks;
    multi-pod (pod=2, data=16, model=16), 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    _need(math.prod(shape), ",".join(f"{n}={s}"
                                     for n, s in zip(names, shape)))
    dev = init_distributed(device)
    return _device_mesh(dev.type, shape, names)


def _rank_main(fn, rank: int, world: int, rdv: str, device, args, out):
    """One spawned rank: join the group, run ``fn``, report, leave."""
    import traceback
    # the ranks share the host's cores (as torchrun's OMP_NUM_THREADS)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        dev = init_distributed(device, init_method="file://" + rdv,
                               rank=rank, world_size=world)
        out.put((rank, True, fn(rank, world, dev, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, device="cpu", timeout: float = 900):
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned
    processes joined in one group (a file rendezvous in a fresh temporary
    directory, no port) on ``device``: the CPU, or the card, which the
    ranks share over gloo unless each has its own.  ``fn`` must be
    importable by the children (a module's top level).  Returns the
    ranks' results in rank order; a rank that fails, a rank that exits
    without a result (a crash, seen within seconds) or a run past
    ``timeout`` seconds stops every rank and raises, with the failed
    rank's traceback when it sent one."""
    import queue

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    rdv = os.path.join(tempfile.mkdtemp(), "rendezvous")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, rdv, str(device), args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    res, err = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(res) < world and err is None:
            try:
                rank, ok, val = out.get(timeout=1.0)
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)}
                if not dead and time.monotonic() < deadline:
                    continue
                try:                    # a failed rank's own report first
                    rank, ok, val = out.get(timeout=5 if dead else 0.1)
                except queue.Empty:
                    err = (f"ranks exited without a result: {dead}" if dead
                           else f"no result from every rank within "
                           f"{timeout} s")
                    break
            if ok:
                res[rank] = val
            else:
                err = f"rank {rank} failed:\n{val}"
    finally:
        for p in procs:
            if err is not None:
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if err is not None:
        raise RuntimeError(err)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [res[r] for r in range(world)]
