#!/usr/bin/env python3
"""Where the time of the sm90 bitlinear / WDM MMM kernels goes, on one
CUDA card (run from the repository root):

    python3 tools/mma_probe.py [--sections fixed,split,epilogue]

- ``fixed``: each tinyllama-1.1b shape of ``chip_smoke.MMA_SHAPES`` at 8
  and 128 rows beside the same grid with one 64-feature k tile per CTA
  (m = 64 * S): launch, pipeline fill and epilogue alone.
- ``split``: the MMM and bitlinear at every split S of the contraction
  from 1 to 8 (the plan's rule picks the one that gives >= 128 CTAs).
- ``epilogue``: the MMM built from copies of ``csrc/sm90_mma.cuh`` with
  parts of its epilogue knocked out (the output store; the split-K
  reduction), each in its own namespace and library under
  ``build/probe/``; the knocked-out builds compute wrong results and
  exist only to be timed.

Times are CUDA-graph replays (``chip_smoke._graph_ms``: 100 launches
cycling weight copies past the 50 MB L2), in ms per launch; the card's
name and power limit come first. No result is checked here beyond each
plan's output against the plain version; ``chip_smoke.py`` is the check.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build, mma_plan  # noqa: E402
from repro_torch.kernels import bitlinear as bl  # noqa: E402
from repro_torch.kernels import wdm_mmm as wm  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

ITERS = 100
SHAPES = list(cs.MMA_SHAPES.values())


def _operands(gen, rows, m, n):
    w = cs._signs(gen, (m, n), torch.bfloat16)
    a = cs._signs(gen, (rows, m), torch.bfloat16)
    x = torch.randn((rows, m), generator=gen, device="cuda").to(torch.bfloat16)
    alpha = torch.rand((n,), generator=gen, device="cuda") + 0.5
    sets = [(w,)] + [(w.clone(),) for _ in range(cs._copies(m * n * 2) - 1)]
    return w, a, x, alpha, sets


def _plan(a, w):
    return mma_plan.choose(a, w, torch.empty((a.shape[0], w.shape[1]), device="cuda"))


def fixed(gen) -> None:
    for rows in (8, 128):
        for m, n in SHAPES:
            w, a, x, alpha, sets = _operands(gen, rows, m, n)
            split = _plan(a, w).split
            line = []
            for mm in (m, mma_plan.BK * split):
                w2, a2, x2, alpha2, sets2 = (w, a, x, alpha, sets) if mm == m else _operands(
                    gen, rows, mm, n)
                if _plan(a2, w2).split != split:
                    raise AssertionError(f"m={mm} plans another split than {split}")
                line.append(
                    f"m={mm}: mmm {cs._graph_ms(lambda w_: wm.mmm(a2, w_), sets2, ITERS):.4f} "
                    f"bitlinear "
                    f"{cs._graph_ms(lambda w_: bl.bitlinear_kernel(x2, w_, alpha2), sets2, ITERS):.4f}"
                    f" torch.matmul {cs._graph_ms(lambda w_: torch.matmul(a2, w_), sets2, ITERS):.4f}")
            print(f"[fixed] rows {rows} n={n} S {split}: " + "; one k tile per CTA, ".join(line),
                  flush=True)


def split_sweep(gen) -> None:
    real = mma_plan._sm_count
    try:
        for rows in (8, 128):
            for m, n in SHAPES:
                w, a, x, alpha, sets = _operands(gen, rows, m, n)
                tiles = -(-n // mma_plan.BN)
                for s in range(1, mma_plan.MAX_SPLIT + 1):
                    mma_plan._sm_count = lambda device, v=s * tiles: v  # split = s
                    p = _plan(a, w)
                    if p.split != s:
                        continue
                    if not torch.equal(wm.mmm(a, w), wm.mmm_plain(a, w)):
                        raise AssertionError(f"mmm != plain at S={s}")
                    t_m = cs._graph_ms(lambda w_: wm.mmm(a, w_), sets, ITERS)
                    t_b = cs._graph_ms(lambda w_: bl.bitlinear_kernel(x, w_, alpha), sets, ITERS)
                    print(f"[split] rows {rows} (m={m}, n={n}) S {s}, {p.ctas} CTAs: mmm {t_m:.4f} "
                          f"bitlinear {t_b:.4f}", flush=True)
    finally:
        mma_plan._sm_count = real


_STORE = "*reinterpret_cast<float4*>(out + static_cast<int64_t>(r0 + r) * n + n0 + c) = sum;"
_LOOP = "for (int q = rank * kThreads + tid;"
KNOCKOUTS = {
    "as built": [],
    "no output store": [(_STORE, "if (sum.x == 12345.f) " + _STORE)],
    "no split-K reduction": [(_LOOP, "for (int q = N * (kBN / 4) + rank * kThreads + tid;")],
}


def epilogue(gen) -> None:
    header = (_build.SRC_DIR / "sm90_mma.cuh").read_text()
    entry = (_build.SRC_DIR / "wdm_mmm.cu").read_text()
    libs, procs = {}, {}
    for i, (name, edits) in enumerate(KNOCKOUTS.items()):
        text = header
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"knock-out {name!r}: {old!r} is not in sm90_mma.cuh")
            text = text.replace(old, new)
        ns = f"sm90mma_probe{i}"  # one namespace per library: no shared template symbols
        d = _build.BUILD_DIR.parent / "probe" / f"variant{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "sm90_mma.cuh").write_text(text.replace("namespace sm90mma", f"namespace {ns}"))
        (d / "k.cu").write_text(entry.replace("sm90mma::", f"{ns}::"))
        procs[name] = (d, subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-I", str(_build.SRC_DIR), "-o", str(d / "lib.so"),
             str(d / "k.cu")]))
    for name, (d, proc) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for {name!r}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.wdm_mmm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.wdm_mmm.restype = ctypes.c_int
        libs[name] = lib
    for rows in (8, 128):
        for m, n in SHAPES:
            w, a, _, _, sets = _operands(gen, rows, m, n)
            p = _plan(a, w)
            line = []
            for name, lib in libs.items():
                def run(w_, lib=lib):
                    o = torch.empty((rows, n), device="cuda")
                    rc = lib.wdm_mmm(a.data_ptr(), w_.data_ptr(), o.data_ptr(), rows, m, n,
                                     *p.args, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: error {rc}")
                    return o
                if name == "as built" and not torch.equal(run(w), wm.mmm_plain(a, w)):
                    raise AssertionError("the unmodified copy != plain version")
                line.append(f"{name} {cs._graph_ms(run, sets, ITERS):.4f}")
            print(f"[epilogue] mmm rows {rows} (m={m}, n={n}) S {p.split}: " + ", ".join(line),
                  flush=True)


SECTIONS = {"fixed": fixed, "split": split_sweep, "epilogue": epilogue}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default=",".join(SECTIONS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mma_probe: needs a CUDA card", file=sys.stderr)
        return 2
    print(cs.smi("name,power.limit"), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(("bitlinear", "wdm_mmm"))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for name in args.sections.split(","):
        SECTIONS[name](gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
