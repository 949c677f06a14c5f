#!/usr/bin/env python3
"""Probes of the tensor-core paths behind the Hamming and flash kernels, on
one CUDA card (run from the repository root):

    python3 tools/tc_probe.py [--sections b1,flash,hamming,fused]

- ``b1``: whether ptxas takes ``mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32``
  with ``.xor.popc`` and with ``.and.popc`` for ``sm_90a``; each form that
  builds is checked on one warp against popcounts on the host (fragment
  layout: A rows g / g + 8 and k words tig / tig + 4, B column g, C rows
  g / g + 8 and columns 2 tig / 2 tig + 1, with g = lane / 4 and tig =
  lane % 4), and its peak is measured: 8 warps per block, 4 blocks per SM,
  each warp issuing independent instructions from registers in a loop.
  One bit-operation is one (a, w) bit pair of the contraction, so an
  instruction is 16 * 8 * 256 of them.
- ``flash``: the sm90 flash kernel built from copies of
  ``csrc/flash_attention.cu`` with parts knocked out -- P.V as one bf16
  term instead of three (what exactness costs), no P.V, no exp in the
  softmax, no QK^T -- and three alternatives: P.V behind the next
  softmax at D = 128 too (within 204 registers, and with up to 255), and
  launch bounds for three CTAs per SM; at the tinyllama-1.1b prefill, the
  continuation and llama3.2-3b's D = 128 (``chip_smoke.FLASH_CASES``).
- ``hamming``: the b1 Hamming kernel from copies of ``csrc/xnor_matmul.cu``
  (with ``csrc/sm90_b1.cuh`` inlined) without the row / column popcounts
  on the CUDA cores, without the tensor-core instructions, without the
  split-K reduction and store, at w1/w3 and w2 with 8, 128 and 1024 rows.
- ``fused``: the b1 fused BitLinear from copies of ``csrc/fused_decode.cu``
  (``sm90_b1.cuh`` inlined) without the binarize-and-pack (the fragments
  read a word tile that is never written), without the x box loads,
  without the tensor-core instructions, without the split-K reduction
  and epilogue; and the shipped build under other plans: one and two
  consumer warpgroups (128- and 256-column n tiles), at 128 and 1024
  rows every other ring depth, at 1024 rows a 64-row tile and a split of
  2 -- at w1/w3, qkv and w2 with 8, 128 and 1024 rows, bf16 x.

Each knock-out is its own library under ``build/probe/tc/`` with its own
namespace; the knocked-out builds compute wrong results and exist only to
be timed. The card's name and power limit come first. The b1 peak is timed
by CUDA events around one launch after a warm-up, the kernels by
``chip_smoke._graph_ms`` (CUDA-graph replay cycling copies of the operands
past the 50 MB L2), in ms per launch.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build, mma_plan, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import xnor_matmul  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

PROBE_DIR = _build.BUILD_DIR.parent / "probe" / "tc"
ITERS = 100

B1_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.BITOP.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A: 16 rows x 8 words, B: 8 columns x 8 words, D: 16 x 8
__global__ void check_kernel(const uint32_t* A, const uint32_t* B, int* D) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  uint32_t a[4] = {A[g * 8 + t], A[(g + 8) * 8 + t], A[g * 8 + t + 4], A[(g + 8) * 8 + t + 4]};
  uint32_t b[2] = {B[g * 8 + t], B[g * 8 + t + 4]};
  int d[4] = {0, 0, 0, 0};
  mma_b1(d, a, b);
  D[g * 8 + 2 * t] = d[0];
  D[g * 8 + 2 * t + 1] = d[1];
  D[(g + 8) * 8 + 2 * t] = d[2];
  D[(g + 8) * 8 + 2 * t + 1] = d[3];
}

__global__ void __launch_bounds__(256) peak_kernel(int* sink, int iters) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = 0x9E3779B9u * (threadIdx.x + 7 * i + 1);
  b[0] = 0x85EBCA6Bu * (threadIdx.x + 3);
  b[1] = 0xC2B2AE35u * (threadIdx.x + 5);
  int d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_b1(d[j], a, b);
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  if (s == 0x7FFFFFFF) sink[blockIdx.x] = s;
}

extern "C" int b1_check(const void* A, const void* B, void* D, void* stream) {
  check_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const uint32_t*)A, (const uint32_t*)B, (int*)D);
  return (int)cudaGetLastError();
}

extern "C" int b1_peak(void* sink, int blocks, int iters, void* stream) {
  peak_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((int*)sink, iters);
  return (int)cudaGetLastError();
}
"""


def _build_b1(op: str) -> tuple[ctypes.CDLL | None, str]:
    d = PROBE_DIR / f"b1_{op}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "k.cu").write_text(B1_SOURCE.replace("BITOP", op))
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
         "-fPIC", "-Xptxas", "-v", "-o", str(d / "lib.so"), str(d / "k.cu")],
        capture_output=True, text=True, timeout=300)
    log = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        return None, log
    lib = ctypes.CDLL(str(d / "lib.so"))
    lib.b1_check.argtypes = [ctypes.c_void_p] * 4
    lib.b1_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.b1_check.restype = lib.b1_peak.restype = ctypes.c_int
    return lib, log


def _popc(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1)


def b1(_gen) -> None:
    rng = np.random.default_rng(0)
    A = rng.integers(0, 2**32, size=(16, 8), dtype=np.uint64).astype(np.uint32)
    B = rng.integers(0, 2**32, size=(8, 8), dtype=np.uint64).astype(np.uint32)
    want = {
        "xor": _popc(A[:, None, :] ^ B[None, :, :]),
        "and": _popc(A[:, None, :] & B[None, :, :]),
    }
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for op in ("xor", "and"):
        lib, log = _build_b1(op)
        if lib is None:
            print(f"[b1] .{op}.popc: ptxas/nvcc refuses it for sm_90a:\n{log}", flush=True)
            continue
        regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines() if "registers" in ln]
        ta = torch.from_numpy(A.view(np.int32)).cuda()
        tb = torch.from_numpy(B.view(np.int32)).cuda()
        td = torch.zeros((16, 8), dtype=torch.int32, device="cuda")
        rc = lib.b1_check(ta.data_ptr(), tb.data_ptr(), td.data_ptr(), stream)
        torch.cuda.synchronize()
        got = td.cpu().numpy()
        ok = rc == 0 and np.array_equal(got, want[op])
        print(f"[b1] .{op}.popc builds for sm_90a ({'; '.join(regs)}); one warp vs host "
              f"popcounts: {'equal' if ok else f'DIFFERENT (rc {rc})'}", flush=True)
        if not ok:
            print(f"[b1]   got\n{got}\n[b1]   want\n{want[op]}", flush=True)
            continue
        sink = torch.zeros(sms * 8, dtype=torch.int32, device="cuda")
        iters = 4096
        for blocks in (sms * 4, sms * 8):
            lib.b1_peak(sink.data_ptr(), blocks, 16, stream)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            rc = lib.b1_peak(sink.data_ptr(), blocks, iters, stream)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            ops = blocks * 8 * iters * 8 * 16 * 8 * 256
            print(f"[b1] .{op}.popc peak: {blocks} blocks x 8 warps x {iters} x 8 instructions "
                  f"in {ms:.4f} ms (rc {rc}): {ops / ms / 1e9:.4g} T bit-operations/s, "
                  f"{ops / ms / 1e3 / 16 / 8 / 256 / sms:.4g} instructions per microsecond per SM",
                  flush=True)


B1_HEADER = '#include "sm90_b1.cuh"'


def _knockouts(source: str, namespace: str, knockouts: dict, signatures: dict) -> dict:
    """Build one library per knock-out from ``csrc/<source>`` (with the b1
    tile loop's header inlined where it includes it) with its text edits
    applied and its ``namespace`` renamed, all in parallel; returns the
    loaded libraries by knock-out name."""
    text = (_build.SRC_DIR / source).read_text()
    if B1_HEADER in text:
        header = (_build.SRC_DIR / "sm90_b1.cuh").read_text().replace("#pragma once\n", "")
        text = text.replace(B1_HEADER, header)
    procs = {}
    for i, (name, edits) in enumerate(knockouts.items()):
        t = text
        for old, new in edits:
            if old not in t:
                raise SystemExit(f"knock-out {name!r}: {old!r} is not in {source}")
            t = t.replace(old, new)
        d = PROBE_DIR / f"{source.split('.')[0]}{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "k.cu").write_text(t.replace(f"namespace {namespace} {{",
                                          f"namespace {namespace}_probe{i} {{")
                                .replace(f"{namespace}::", f"{namespace}_probe{i}::"))
        procs[name] = (d, subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-I", str(_build.SRC_DIR), "-o", str(d / "lib.so"),
             str(d / "k.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {source} {name!r}:\n{log}")
        # each kernel instance's registers and spills, and any serialized wgmma
        facts = [ln.split(":", 1)[-1].strip()[:120] for ln in log.splitlines()
                 if "Used" in ln or "spill stores" in ln or "C75" in ln]
        print(f"[ptxas] {source} {name}: " + " | ".join(facts), flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


_PV = "    WgmmaRS<D>::mma(acc, ph + 4 * kk, dv);\n"
_PV_MID_LO = ("    WgmmaRS<D>::mma(acc, pm + 4 * kk, dv);\n"
              "    WgmmaRS<D>::mma(acc, pl + 4 * kk, dv);\n")
_OVERLAP = "__host__ __device__ constexpr bool overlap() { return D == 64; }"
_BOUNDS = "__launch_bounds__(kThreads, 2)\n    flash_sm90_kernel"
FLASH_KNOCKOUTS = {
    "as built": [],
    "one P.V term": [(_PV_MID_LO, "")],
    "no P.V": [(_PV + _PV_MID_LO, "")],
    "no exp": [("expf(sc[j] - m_r[i])", "(sc[j] - m_r[i])")],
    "no QK^T": [("    WgmmaSS<kBKeys>::mma(sc, smem_desc(q_addr + off, 16, 1024), "
                 "smem_desc(k_addr + off, 16, 1024));\n", "")],
    # not knock-outs: P.V behind the next softmax at D = 128 too, within the
    # launch bounds' 204 registers and with up to 255; three CTAs per SM
    "overlap at D=128": [(_OVERLAP, _OVERLAP.replace("D == 64", "true"))],
    "overlap at D=128, 255 registers": [(_OVERLAP, _OVERLAP.replace("D == 64", "true")),
                                        (_BOUNDS, _BOUNDS.replace("2)", "1)"))],
    "3 CTAs per SM": [(_BOUNDS, _BOUNDS.replace("2)", "3)"))],
}
FLASH_PROBE_CASES = ("tinyllama prefill", "continuation 64 over 320", "llama3.2-3b D=128")


def flash(gen) -> None:
    libs = _knockouts("flash_attention.cu", "fa90", FLASH_KNOCKOUTS,
                      {"flash_attention_sm90": fa._ARGTYPES})
    for label, b, h, kvh, sq, skv, d, causal in cs.FLASH_CASES:
        if label not in FLASH_PROBE_CASES:
            continue
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, kvh, skv, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, kvh, skv, d), generator=gen, device="cuda").to(torch.bfloat16)
        nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
        sets = [(q, k, v)] + [(q.clone(), k.clone(), v.clone())
                              for _ in range(cs._copies(nbytes) - 1)]
        line = []
        for name, lib in libs.items():
            def run(q_, k_, v_, lib=lib):
                o = torch.empty_like(q_)
                rc = lib.flash_attention_sm90(
                    q_.data_ptr(), *q_.stride()[:3], k_.data_ptr(), *k_.stride()[:3],
                    v_.data_ptr(), *v_.stride()[:3], o.data_ptr(), b, h, kvh, sq, skv, d,
                    int(causal), skv - sq if causal else 0,
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: error {rc}")
                return o
            if name == "as built" and not torch.equal(run(q, k, v), fa.flash_attention(q, k, v)):
                raise AssertionError("the unmodified copy != the shipped kernel")
            line.append(f"{name} {cs._graph_ms(run, sets, ITERS):.4f}")
        print(f"[flash] {label} (B={b} H={h} KV={kvh} Sq={sq} Skv={skv} D={d}): "
              + ", ".join(line), flush=True)


HAMMING_KNOCKOUTS = {
    "as built": [],
    "no CUDA-core popcounts": [
        ("        rowp[nt] += __popc(bf[nt].x) + __popc(bf[nt].y);\n", ""),
        ("        colp[x][0] += __popc(w0.x) + __popc(w1.x);\n"
         "        colp[x][1] += __popc(w0.y) + __popc(w1.y);\n"
         "        colp[x][2] += __popc(w0.z) + __popc(w1.z);\n"
         "        colp[x][3] += __popc(w0.w) + __popc(w1.w);\n", "")],
    "no tensor-core instructions": [
        ("          mma_and(acc[x][0][nt], w0.x, w0.y, w1.x, w1.y, bf[nt].x, bf[nt].y);\n"
         "          mma_and(acc[x][1][nt], w0.z, w0.w, w1.z, w1.w, bf[nt].x, bf[nt].y);\n", "")],
    "no reduction or store": [("  for (int q = rank * kThreads + tid; q < N * (kCols / 4);",
                               "  for (int q = N * (kCols / 4) + rank * kThreads + tid; q < N * (kCols / 4);")],
}


def hamming(gen) -> None:
    libs = _knockouts("xnor_matmul.cu", "b1", HAMMING_KNOCKOUTS,
                      {"hamming_matmul_b1": xnor_matmul._B1_ARGTYPES})
    for rows in (8, 128, 1024):
        for name_, (m, n) in (("w1/w3", cs.SHAPES["w1/w3"]), ("w2", cs.SHAPES["w2"])):
            signs = torch.where(torch.randn((m, n), generator=gen, device="cuda") >= 0, 1.0, -1.0)
            wp = ops.pack_weights(signs)
            a = ops.pack_bits(torch.randn((rows, m), generator=gen, device="cuda") >= 0)
            kw = a.shape[1]
            out = torch.empty((rows, n), dtype=torch.int32, device="cuda")
            plan = mma_plan.choose_hamming(a, wp, out)
            sets = [(wp,)] + [(wp.clone(),) for _ in range(cs._copies(wp.numel() * 4) - 1)]
            line = []
            for name, lib in libs.items():
                def run(w_, lib=lib):
                    o = torch.empty((rows, n), dtype=torch.int32, device="cuda")
                    rc = lib.hamming_matmul_b1(a.data_ptr(), a.stride(0), w_.data_ptr(),
                                               w_.stride(0), o.data_ptr(), rows, n, kw,
                                               *plan.args, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: error {rc}")
                    return o
                if name == "as built" and not torch.equal(
                        run(wp), xnor_matmul.hamming_matmul_plain(a, wp)):
                    raise AssertionError("the unmodified copy != the plain version")
                line.append(f"{name} {cs._graph_ms(run, sets, ITERS):.4f}")
            print(f"[hamming] {name_} rows {rows} ({plan.describe()}): " + ", ".join(line),
                  flush=True)


FUSED_KNOCKOUTS = {
    "as built": [],
    "no pack": [("        Act::template pack<N, kConsumers>(at, tile, tid, (kt0 + i) * kStageFeatures, m);\n",
                 "")],
    "no x box loads": [("        mbar_expect_tx(&full[s], kWStage + kXBytes);",
                        "        mbar_expect_tx(&full[s], kWStage);"),
                       ("        tma_load(xring + s * kXBytes, &ta, &full[s], k0 * Act::kWordsPerCoord, r0);\n",
                        "")],
    "no tensor-core instructions": HAMMING_KNOCKOUTS["no tensor-core instructions"],
    "no reduction or epilogue": HAMMING_KNOCKOUTS["no reduction or store"],
}


def fused(gen) -> None:
    from repro_torch.kernels import fused_decode

    libs = _knockouts("fused_decode.cu", "b1", FUSED_KNOCKOUTS,
                      {"fused_bnn_matmul_b1_bf16": fused_decode._B1_ARGTYPES})
    for rows in (8, 128, 1024):
        for name_ in ("w1/w3", "qkv", "w2"):
            m, n = cs.SHAPES[name_]
            x, _, wp, alpha, beta = cs._case(gen, rows, m, n, False)
            want = fused_decode.fused_bnn_matmul_plain(x, wp, alpha, beta, m=m, n=n)
            sets = [(wp,)] + [(wp.clone(),) for _ in range(cs._copies(wp.numel() * 4) - 1)]
            shipped = mma_plan.fused_plan(rows, m, n, 2)
            kt = -(-m // mma_plan.FUSED_FEATURES)
            plans = {f"{wg} warpgroup{'s' if wg > 1 else ''}": mma_plan.fused_plan(rows, m, n, 2, wg=wg)
                     for wg in mma_plan.FUSED_WGS}
            if rows >= 128:  # every other ring depth (fewer stages: more CTAs per SM)
                plans.update({
                    f"{s} stages": dataclasses.replace(shipped, stages=s)
                    for s in range(2, min(mma_plan.HAM_MAX_STAGES, max(2, -(-kt // shipped.split))) + 1)
                    if s != shipped.stages
                    and mma_plan.fused_smem_bytes(shipped.row_tile, shipped.wg, 2, s) <= mma_plan.MAX_SMEM})
            if rows >= 1024:  # a 64-row tile (one CTA per SM), a split of 2
                plans["row tile 64, 5 stages"] = dataclasses.replace(
                    shipped, row_tile=64, stages=5, grid=(1, shipped.grid[1], -(-rows // 64)))
                plans["split 2"] = dataclasses.replace(shipped, split=2, grid=(2, *shipped.grid[1:]))
            line = []

            def run(w_, lib, plan):
                o = torch.empty((rows, n), device="cuda")
                rc = lib.fused_bnn_matmul_b1_bf16(
                    x.data_ptr(), x.stride(0), w_.data_ptr(), w_.stride(0), alpha.data_ptr(),
                    beta.data_ptr(), o.data_ptr(), rows, n, m, *plan.args,
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{plan.describe()}: error {rc}")
                return o

            for name, lib in libs.items():
                if name == "as built":
                    for label, plan in plans.items():
                        if not torch.equal(run(wp, lib, plan), want):
                            raise AssertionError(f"the unmodified copy != the plain version "
                                                 f"({plan.describe()})")
                        ms = cs._graph_ms(lambda w_: run(w_, lib, plan), sets, ITERS)
                        line.append(f"{label} (row tile {plan.row_tile}, split {plan.split}, "
                                    f"{plan.ctas} CTAs, {plan.stages} stages) {ms:.4f}")
                    continue
                line.append(f"{name} {cs._graph_ms(lambda w_: run(w_, lib, shipped), sets, ITERS):.4f}")
            print(f"[fused] {name_} rows {rows} (shipped: {shipped.describe()}): " + ", ".join(line),
                  flush=True)


SECTIONS = {"b1": b1, "flash": flash, "hamming": hamming, "fused": fused}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default=",".join(SECTIONS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tc_probe: needs a CUDA card", file=sys.stderr)
        return 2
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in args.sections.split(","):
        SECTIONS[name](gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
