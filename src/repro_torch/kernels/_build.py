"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/kernels/lib<name>-<digest>.so`` at the repository root
(``.gitignore`` lists ``build/``); the digest of the source and of every
shared header ``csrc/*.cuh`` names the library, so an edited source or
header never loads a stale build. Building happens at first use, inside
the call that needs a kernel, never at import. ``sm90_mma.cuh`` finds
``cuTensorMapEncodeTiled`` through the runtime's driver entry point, so
nothing links against ``libcuda``; it raises its dynamic shared-memory
limit with ``cudaFuncSetAttribute`` once per process and kernel.

There is no fallback: a missing ``nvcc`` or a failed compile raises
:class:`KernelBuildError` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("xnor_matmul", "fused_decode", "flash_attention", "bitlinear", "wdm_mmm")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LOADED: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing, or a kernel source failed to compile or load."""


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise KernelBuildError(
        "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch build only where the CUDA toolkit is "
        "installed; CPU tensors use the plain PyTorch versions instead"
    )


def library_path(name: str) -> Path:
    """Where the shared library of kernel ``name`` is (or will be) built."""
    if name not in KERNELS:
        raise KernelBuildError(f"unknown kernel {name!r}; known: {', '.join(KERNELS)}")
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: tuple[str, ...] = KERNELS) -> dict[str, float]:
    """Compile every kernel in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns the seconds each
    build took (0.0 for a library that was already there). ``nvcc``'s
    output, register and shared-memory use included (``-Xptxas -v``),
    is kept beside each library as ``<lib>.log``."""
    todo = {n: library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.is_file()}
    seconds = {n: 0.0 for n in names}
    if not todo:
        return seconds
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(tmp), str(SRC_DIR / f"{name}.cu"),
        ]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """``nvcc``'s output from building kernel ``name`` ('' if none kept)."""
    log = library_path(name).with_suffix(".so.log")
    return log.read_text() if log.is_file() else ""


def load(name: str, signatures: dict[str, list] | None = None) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed. At the
    first load each C function in ``signatures`` gets its ``argtypes``
    (the list given) and an ``int`` return type, once per process."""
    lib = _LOADED.get(name)
    if lib is None:
        build((name,))
        try:
            lib = ctypes.CDLL(str(library_path(name)))
        except OSError as e:
            raise KernelBuildError(f"cannot load the {name} kernel library: {e}") from e
        for fn_name, argtypes in (signatures or {}).items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def on_device(device: torch.device, fn, *args):
    """``fn(*args, stream)`` on ``device``'s current stream, switching the
    current device only when it is another one (the switch costs a few
    microseconds of host time per launch)."""
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    return fn(*args, torch.cuda.current_stream(device).cuda_stream)
