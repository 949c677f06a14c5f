"""The port stands alone: it imports nothing of JAX or of the JAX
package, runs on the CPU only when asked, and has no fallback from its
CUDA kernels (no ``nvcc`` means a named build error, and a tensor on a
device other than the CPU never takes the plain version)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import compiler
from repro_torch.configs import ARCH_IDS, SERVED, get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.device import CudaUnavailableError
from repro_torch.kernels import (
    _build,
    bitlinear,
    flash_attention,
    fused_decode,
    ops,
    wdm_mmm,
    xnor_matmul,
)
from repro_torch.launch import serve
from repro_torch.models import lm

# smoke shapes gain nothing from intra-op threads, which only contend
# with the other test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*.py")))


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = {
        n for n in _imports(path)
        if n.split(".")[0] in ("jax", "jaxlib", "flax", "repro")
    }
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_serve_driver_loads_no_jax():
    code = (
        "import sys; import repro_torch.launch.serve, repro_torch.convert, "
        "repro_torch.compiler, repro_torch.serving, repro_torch.fleet, "
        "repro_torch.kernels.ops, repro_torch.kernels.ref, repro_torch.kernels.flash_attention, "
        "repro_torch.obs, repro_torch.obs.trace, repro_torch.obs.metrics, "
        "repro_torch.obs.crosscheck, repro_torch.mapping, repro_torch.core.costmodel, "
        "repro_torch.core.einsteinbarrier; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _needs_no_cuda()
    cfg = get_smoke_config("tinyllama-1.1b")
    with pytest.raises(CudaUnavailableError):
        lm.init_params(torch.Generator(), cfg)
    params = lm.init_params(torch.Generator(), cfg, device="cpu")
    with pytest.raises(CudaUnavailableError):
        compiler.compile(cfg, params, compiler.HardwareTarget(engine="packed"))
    with pytest.raises(CudaUnavailableError):
        params_from_jax({"blocks": {}})
    with pytest.raises(CudaUnavailableError):
        serve.run(["--arch", "tinyllama-1.1b", "--smoke", "--engine", "packed"])
    # asked for explicitly, the CPU runs
    cm = compiler.compile(cfg, params, compiler.HardwareTarget(engine="packed"), device="cpu")
    assert cm.device.type == "cpu"
    cm_serve = cm.serve(max_batch=2, max_len=16)
    assert cm_serve.caches["slot0"]["k"].device.type == "cpu"


def test_build_raises_named_error_without_nvcc(monkeypatch):
    try:
        _build.nvcc_path()
    except _build.KernelBuildError:
        pass
    else:
        pytest.skip("nvcc is installed here")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()
    with pytest.raises(_build.KernelBuildError):
        _build.load("fused_decode")
    with pytest.raises(_build.KernelBuildError, match="unknown kernel"):
        _build.library_path("nope")


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    """Only a CPU tensor runs the plain version; anything else launches
    the kernel or raises (the meta device stands in here for a device
    without a kernel)."""
    before = (fused_decode.launches, xnor_matmul.launches)
    x = torch.empty((2, 64), device="meta")
    w = torch.empty((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no fused BitLinear kernel"):
        fused_decode.fused_bnn_matmul_kernel(
            x, w, torch.empty(8, device="meta"), torch.empty(2, device="meta"), m=64, n=8
        )
    with pytest.raises(ValueError, match="no Hamming kernel"):
        xnor_matmul.hamming_matmul_packed(torch.empty((2, 2), dtype=torch.int32, device="meta"), w)
    # plain-version calls on the CPU are not kernel launches
    ops.fused_bnn_matmul(torch.randn(3, 64), ops.pack_weights(torch.ones(64, 8)), 1.0, m=64, n=8)
    ops.xnor_matmul(torch.ones(3, 64), torch.ones(64, 8))
    assert (fused_decode.launches, xnor_matmul.launches) == before


def test_later_slices_are_named():
    for arch in ARCH_IDS:
        if arch in SERVED:
            assert get_config(arch).name == arch
            continue
        with pytest.raises(NotImplementedError, match="slice"):
            get_config(arch)
    for engine in ("tacitmap", "wdm", "tiled", "custbinarymap"):
        assert compiler.HardwareTarget(engine=engine).validate().engine == engine
    with pytest.raises(compiler.PlanEngineMismatchError):
        compiler.HardwareTarget(engine="wdm", mapping_policy="tacitmap").validate()
    with pytest.raises(compiler.TargetError, match="fused=False"):
        compiler.HardwareTarget(engine="reference", fused=False).validate()
    with pytest.raises(compiler.GroupSizeError):
        compiler.HardwareTarget(engine="packed", group_size=-1).validate()
    assert repro_torch.__doc__


NEW_MODULES = ("fleet/pool.py", "fleet/replica.py", "fleet/router.py", "kernels/ref.py",
               "kernels/flash_attention.py", "kernels/bitlinear.py", "kernels/wdm_mmm.py",
               "kernels/mma_plan.py", "obs/__init__.py", "obs/trace.py", "obs/metrics.py",
               "obs/crosscheck.py", "core/tacitmap.py", "core/wdm.py", "core/custbinarymap.py",
               "core/networks.py", "core/costmodel.py", "core/einsteinbarrier.py",
               "mapping/__init__.py", "mapping/ir.py", "mapping/allocator.py",
               "mapping/schedule.py", "mapping/report.py")


def test_import_scan_covers_the_new_modules():
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").as_posix() for p in PORT_FILES
               if p.is_relative_to(ROOT / "src" / "repro_torch")}
    assert set(NEW_MODULES) <= scanned


def test_new_wrappers_raise_for_a_cuda_tensor_without_a_card():
    """A CUDA tensor (a fake one: there is no card here) goes to the
    kernel, whose build fails without ``nvcc``; it never takes the plain
    version, and no launch is counted."""
    _needs_no_cuda()
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = (flash_attention.launches, bitlinear.launches, wdm_mmm.launches)
    with FakeTensorMode():
        q = torch.empty((1, 4, 8, 64), device="cuda", dtype=torch.bfloat16)
        kv = torch.empty((1, 2, 8, 64), device="cuda", dtype=torch.bfloat16)
        x = torch.empty((3, 64), device="cuda")
        w = torch.empty((64, 8), device="cuda", dtype=torch.bfloat16)
        calls = (
            lambda: flash_attention.flash_attention(q, kv, kv),
            lambda: bitlinear.bitlinear_kernel(x, w, torch.empty(8, device="cuda")),
            lambda: wdm_mmm.mmm(x.to(torch.bfloat16), w),
            lambda: ops.bitlinear(x, w.float(), torch.empty(8, device="cuda")),
            lambda: ops.wdm_mmm(x.reshape(1, 3, 64), w),
        )
        for call in calls:
            with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
                call()
    assert (flash_attention.launches, bitlinear.launches, wdm_mmm.launches) == before


@pytest.mark.parametrize("rows,m,n", [(8, 2048, 5632), (9, 513, 3)], ids=["aligned", "ragged"])
def test_mma_wrappers_raise_for_a_cuda_tensor_at_either_variant_shape(monkeypatch, rows, m, n):
    """An aligned shape (the sm90 variant's) and a ragged one (the WMMA
    variant's) on a fake CUDA tensor both reach the build error: no
    launch is counted, for either variant, and the plain version never
    runs."""
    _needs_no_cuda()
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(bitlinear, "bitlinear_plain", no_plain)
    monkeypatch.setattr(wdm_mmm, "mmm_plain", no_plain)
    before = (bitlinear.launches, dict(bitlinear.launches_by_variant),
              wdm_mmm.launches, dict(wdm_mmm.launches_by_variant))
    with FakeTensorMode():
        x = torch.empty((rows, m), device="cuda", dtype=torch.bfloat16)
        w = torch.empty((m, n), device="cuda", dtype=torch.bfloat16)
        alpha = torch.empty(n, device="cuda")
        calls = (
            lambda: bitlinear.bitlinear_kernel(x, w, alpha),
            lambda: bitlinear.bitlinear_kernel(x.float(), w, alpha),
            lambda: wdm_mmm.mmm(x, w),
            lambda: ops.bitlinear(x, w.float(), alpha),
            lambda: ops.wdm_mmm(x.reshape(1, rows, m), w),
        )
        for call in calls:
            with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
                call()
    assert before == (bitlinear.launches, dict(bitlinear.launches_by_variant),
                      wdm_mmm.launches, dict(wdm_mmm.launches_by_variant))


@pytest.mark.parametrize("rows,m,n,dtype", [(8, 2048, 5632, torch.bfloat16),
                                            (1024, 2048, 256, torch.float32),
                                            (3, 100, 48, torch.bfloat16)],
                         ids=["b1 bf16", "b1 fp32", "popc"])
def test_fused_and_hamming_wrappers_raise_for_a_cuda_tensor_at_either_variant_shape(
        monkeypatch, rows, m, n, dtype):
    """The fused BitLinear and Hamming wrappers on fake CUDA tensors at a
    b1 shape and a popc shape reach the build error: no launch is counted
    for either variant, and the plain versions never run."""
    _needs_no_cuda()
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(fused_decode, "fused_bnn_matmul_plain", no_plain)
    monkeypatch.setattr(xnor_matmul, "hamming_matmul_plain", no_plain)
    before = (fused_decode.launches, dict(fused_decode.launches_by_variant),
              xnor_matmul.launches, dict(xnor_matmul.launches_by_variant))
    kw = -(-m // 32)
    with FakeTensorMode():
        x = torch.empty((rows, m), device="cuda", dtype=dtype)
        w = torch.empty((kw, n), device="cuda", dtype=torch.int32)
        a = torch.empty((rows, kw), device="cuda", dtype=torch.int32)
        calls = (
            lambda: fused_decode.fused_bnn_matmul_kernel(
                x, w, torch.empty(n, device="cuda"), torch.empty(rows, device="cuda"), m=m, n=n),
            lambda: xnor_matmul.hamming_matmul_packed(a, w),
        )
        for call in calls:
            with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
                call()
    assert before == (fused_decode.launches, dict(fused_decode.launches_by_variant),
                      xnor_matmul.launches, dict(xnor_matmul.launches_by_variant))
