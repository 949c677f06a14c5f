"""The kernel build on the CPU: what names a library (the source and every
shared header), and ``_build.load`` setting each C function's signature
once, when the library is loaded."""

import ctypes

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def tmp_csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "shared.cuh"\nextern "C" int k() { return f(); }\n')
    (src / "shared.cuh").write_text("inline int f() { return 1; }\n")
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "KERNELS", ("k",))
    return src


def test_editing_a_shared_header_renames_the_library(tmp_csrc):
    first = _build.library_path("k")
    assert first == _build.library_path("k")  # stable while nothing changes
    (tmp_csrc / "shared.cuh").write_text("inline int f() { return 2; }\n")
    second = _build.library_path("k")
    assert second != first and second.parent == first.parent
    (tmp_csrc / "other.cuh").write_text("// a new header\n")
    assert _build.library_path("k") not in (first, second)
    (tmp_csrc / "k.cu").write_text('#include "shared.cuh"\nextern "C" int k() { return 3; }\n')
    assert _build.library_path("k").name.startswith("libk-")


def test_the_shipped_kernels_share_the_mma_header():
    for name in ("bitlinear", "wdm_mmm"):
        assert '#include "sm90_mma.cuh"' in (_build.SRC_DIR / f"{name}.cu").read_text()
    assert (_build.SRC_DIR / "sm90_mma.cuh").is_file()


class _FakeFn:
    argtypes = None
    restype = None


class _FakeLib:
    def __init__(self, path):
        self.path = path
        self.entry = _FakeFn()
        self.other = _FakeFn()


def test_load_sets_signatures_once(monkeypatch):
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "KERNELS", ("k",))
    monkeypatch.setattr(_build, "library_path", lambda name: f"/nowhere/lib{name}.so")
    monkeypatch.setattr(_build, "build", lambda names: {n: 0.0 for n in names})
    monkeypatch.setattr(ctypes, "CDLL", _FakeLib)
    sig = [ctypes.c_void_p, ctypes.c_int]
    lib = _build.load("k", {"entry": sig})
    assert lib.entry.argtypes == sig and lib.entry.restype is ctypes.c_int
    assert lib.other.argtypes is None
    lib.entry.argtypes = "untouched"
    assert _build.load("k", {"entry": sig}) is lib  # cached: nothing set again
    assert lib.entry.argtypes == "untouched"
