"""Meshes on ``torch.distributed`` (counterpart of ``repro/launch/mesh.py``).

Topology mapping, as the reference's: ``model`` is the innermost axis
(adjacent ranks: TP/EP collectives ride the fastest links), ``data``
spans the pod (FSDP/DP all-reduces), and ``pod`` crosses pods (only
pure-DP gradient reductions, optionally int8-compressed).

A mesh needs a process group with one rank per mesh position.
:func:`init_distributed` starts it with an explicit backend: ``nccl``
when every rank has its own GPU; on a host with fewer GPUs than ranks
NCCL refuses two ranks on one device, so the caller must ask for
``gloo`` (:class:`SharedDeviceError` otherwise -- never a silent
switch). :func:`production_mesh_shape` gives the production meshes'
names and sizes with no process group (``MeshShape(axes, shape)`` a test
mesh's), which is all the spec rules and the dry-run read.
"""

from __future__ import annotations

import datetime
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.distributed.partitioner import MeshShape


class SharedDeviceError(RuntimeError):
    """More ranks than CUDA devices on ``nccl`` (NCCL refuses two ranks
    on one device): pass ``backend="gloo"`` to share the devices."""


class MeshSizeError(RuntimeError):
    """The process group's world size is not the mesh's size."""


class WorldError(RuntimeError):
    """A rank of a local world failed or outlived the world's deadline."""


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def choose_backend(device="cuda", world_size: int = 1, backend: str | None = None) -> str:
    """The process group backend for ``world_size`` ranks on ``device``:
    ``gloo`` on the CPU, ``nccl`` on CUDA when each rank has its own
    device, else :class:`SharedDeviceError` unless ``backend="gloo"``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo runs there")
        return "gloo"
    if backend is not None:
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"unknown backend {backend!r}: use 'nccl' or 'gloo'")
        if backend == "nccl" and world_size > torch.cuda.device_count():
            raise SharedDeviceError(_shared_msg(world_size))
        return backend
    if world_size > torch.cuda.device_count():
        raise SharedDeviceError(_shared_msg(world_size))
    return "nccl"


def _shared_msg(world_size: int) -> str:
    return (f"{world_size} ranks on {torch.cuda.device_count()} CUDA device(s): NCCL refuses "
            "two ranks on one device; pass backend='gloo' to share them")


def init_distributed(rank: int, world_size: int, *, init_method: str | None = None,
                     store=None, device="cuda", backend: str | None = None,
                     timeout_s: float = 300.0) -> str:
    """Start this rank's default process group (``init_method`` such as
    ``tcp://localhost:<port>`` or ``file://<path>``, or a ``store``) on
    the backend :func:`choose_backend` gives; on CUDA, bind the rank to
    device ``rank % device_count``. Returns the backend."""
    be = choose_backend(device, world_size, backend)
    if resolve_device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(be, init_method=init_method, store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return be


def _device_mesh(shape, axes, device) -> DeviceMesh:
    if not dist.is_initialized():
        raise MeshSizeError("no process group: call init_distributed first")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise MeshSizeError(f"mesh {tuple(shape)} needs {n} ranks, the group has "
                            f"{dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> DeviceMesh:
    """(16, 16) ``data`` x ``model``, or (2, 16, 16) with ``pod``: 256 or
    512 ranks."""
    ms = production_mesh_shape(multi_pod=multi_pod)
    return _device_mesh(ms.sizes, ms.axis_names, device)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), device="cuda",
                   backend: str | None = None) -> DeviceMesh:
    """A small mesh over the current process group, whose backend must be
    the one :func:`choose_backend` gives for ``device`` and ``backend``
    (a group on another backend raises rather than run on it)."""
    want = choose_backend(device, math.prod(shape), backend)
    if dist.is_initialized() and dist.get_backend() != want:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, the mesh wants "
                         f"{want!r}")
    return _device_mesh(shape, axes, device)


def run_local_world(worker, world_size: int, *, workdir, payload=None, device="cuda",
                    backend: str | None = None, timeout_s: float = 600.0) -> list:
    """Run ``worker(rank, world_size, payload)`` on ``world_size``
    processes of this host (``spawn``), each in one process group over a
    ``FileStore`` under ``workdir`` (no port), on the backend
    :func:`choose_backend` gives. Returns each rank's result (saved with
    ``torch.save``), in rank order. The world has one deadline: a rank
    still running at ``timeout_s`` is killed, and that or any rank's
    failure raises :class:`WorldError` with the ranks' tracebacks.
    ``worker`` must be a module-level function (it is sent by name)."""
    import torch.multiprocessing as mp

    be = choose_backend(device, world_size, backend)
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_world_entry, daemon=True,
                         args=(worker, r, world_size, str(work), payload, device, be, timeout_s))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(30)
    errors = {r: (work / f"error{r}.txt").read_text() for r in range(world_size)
              if (work / f"error{r}.txt").exists()}
    codes = [p.exitcode for p in procs]
    if hung or errors or any(c != 0 for c in codes):
        killed = f", ranks {hung} killed at the {timeout_s} s deadline" if hung else ""
        raise WorldError(f"world of {world_size}: exit codes {codes}{killed}, errors {errors}")
    return [torch.load(work / f"result{r}.pt", weights_only=False) for r in range(world_size)]


def _world_entry(worker, rank: int, world_size: int, workdir: str, payload, device,
                 backend: str, timeout_s: float) -> None:
    work = Path(workdir)
    try:
        init_distributed(rank, world_size, store=dist.FileStore(str(work / "store"), world_size),
                         device=device, backend=backend, timeout_s=timeout_s)
        # every rank connected before any runs: a rank whose worker returns
        # at once would otherwise close its pairs under one still connecting
        dist.barrier()
        torch.save(worker(rank, world_size, payload), work / f"result{rank}.pt")
    except BaseException:
        (work / f"error{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
