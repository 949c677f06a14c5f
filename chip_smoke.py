#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (device 0), the CUDA toolkit's ``nvcc`` and
``nvidia-smi``; exits non-zero without them. Phases, each announced on
its own ``[phase]`` line:

1. device: card name and power limit, TF32 off for fp32 matmuls;
2. build: the five CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` each, all started together;
3. kernels: each kernel against its plain PyTorch version -- the fused
   BitLinear and Hamming kernels at the tinyllama-1.1b projection shapes
   (bit-exact, ``torch.equal``), flash attention on prefill,
   continuation, ragged, D = 128 and non-causal cases (within a stated
   tolerance), bitlinear and the WDM MMM at the projection shapes
   (``torch.equal``) -- with kernel, plain-version and one-PyTorch-call
   times and the card's bound;
4. entry points: ``ops.bitlinear`` / ``ops.wdm_mmm`` against the dense
   oracles, the path of those two kernels;
5. serve: tinyllama-1.1b at full width (random weights from a seeded
   generator) through ``repro_torch.launch.serve``: a lockstep batch on
   the ``packed`` engine, the same batch under ``--raw-weights`` and on
   the ``reference`` engine (tokens must match), and the request
   scheduler path. The kernels' launch counts are read around each run,
   and a few decode ticks run under ``torch.profiler`` to show where a
   tick's time goes;
6. serve pallas: the same model with ``attn_impl="pallas"`` -- lockstep,
   ``prefill_continue`` == ``prefill``, a 2-replica prefix-routed fleet,
   batched == alone -- after a check that the port's per-row ops give a
   row the same bits whatever the row count.

Then one ``{"kernels": [...]}`` JSON line, the card line again, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM figures (NVIDIA data sheet; CUDA C++ Programming Guide,
# arithmetic-instruction throughput table: 16 32-bit popcounts per clock
# per SM on compute capability 9.0). Dense peaks: 989 TFLOP/s bf16 on
# the tensor cores, 67 TFLOP/s fp32 outside them.
HBM_BYTES_PER_S = 3.35e12
POPC_PER_CLOCK_PER_SM = 16
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12

# tinyllama-1.1b projection shapes (m, n): d_model 2048, 32 heads and 4
# KV heads of 64, d_ff 5632
SHAPES = {
    "qkv": (2048, 2560),
    "q/o": (2048, 2048),
    "k/v": (2048, 256),
    "w1/w3": (2048, 5632),
    "w2": (5632, 2048),
}
ROWS = (8, 128)  # a decode tick of 8 slots; one 128-token prompt prefill
# one layer's launches per decode tick: fused [q|k|v], o, w1, w3, w2;
# unfused / raw-weights q, k, v, o, w1, w3, w2
LAYER_FUSED = ("qkv", "q/o", "w1/w3", "w1/w3", "w2")
LAYER_HAMMING = ("q/o", "k/v", "k/v", "q/o", "w1/w3", "w1/w3", "w2")


def phase(name: str) -> None:
    print(f"[phase] {name}", flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def check_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        raise SystemExit(2)
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"sm clock max {clock_mhz:.0f} MHz, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    return card, clock_mhz


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def build_kernels() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"[build] {', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())} "
          f"(all {time.perf_counter() - t0:.1f} s, started together)", flush=True)
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------


def _time_ms(fn, arg_sets, iters: int) -> float:
    """Mean ms of ``fn(*args)`` with CUDA events, cycling through
    ``arg_sets`` (copies of the weights sized past the 50 MB L2, so each
    launch reads its weights from device memory as the serving path
    does), after a warm-up pass."""
    import torch

    for args in arg_sets[: min(3, len(arg_sets))]:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _copies(nbytes: int) -> int:
    return max(1, min(64, math.ceil(120e6 / nbytes)))


def _case(gen, rows: int, m: int, n: int, prepad: bool):
    import torch

    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    x = torch.randn((rows, m), generator=gen, device=dev).to(torch.bfloat16)
    w_signs = torch.where(torch.randn((m, n), generator=gen, device=dev) >= 0, 1.0, -1.0)
    wp = ops.pack_weights(w_signs)
    if prepad:
        wp = ops.pad_packed_weights(wp)
    alpha = torch.rand((n,), generator=gen, device=dev) + 0.5
    beta = x.abs().float().mean(dim=-1)
    return x, w_signs, wp, alpha, beta


def check_kernels(clock_mhz: float) -> dict:
    """Every kernel against its plain version; returns per-kernel,
    per-shape records for the summary line."""
    import torch

    from repro_torch.kernels import fused_decode, ops, xnor_matmul

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    popc_per_s = POPC_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count * clock_mhz * 1e6
    cases = [(f"{name} B={b}", b, m, n, False) for name, (m, n) in SHAPES.items() for b in ROWS]
    cases += [("ragged m=100 n=48 B=3", 3, 100, 48, False),
              ("prepad m=100 n=48 B=3", 3, 100, 48, True),
              ("prepad m=300 n=200 B=8", 8, 300, 200, True)]
    rec = {"fused_bnn_matmul": {}, "hamming_matmul": {}}
    worst = {"fused_bnn_matmul": 0.0, "hamming_matmul": 0.0}
    for label, b, m, n, prepad in cases:
        x, w_signs, wp, alpha, beta = _case(gen, b, m, n, prepad)
        kw = -(-m // 32)
        a = ops.pack_bits(x >= 0)

        got = fused_decode.fused_bnn_matmul_kernel(x, wp, alpha, beta, m=m, n=n)
        want = fused_decode.fused_bnn_matmul_plain(x, wp, alpha, beta, m=m, n=n)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fused kernel != plain version at {label}: max "
                                 f"|diff| {(got - want).abs().max().item()}")
        worst["fused_bnn_matmul"] = max(worst["fused_bnn_matmul"], (got - want).abs().max().item())
        ham = xnor_matmul.hamming_matmul_packed(a, wp, n=n)
        ham_plain = xnor_matmul.hamming_matmul_plain(a, wp[:kw, :n])
        torch.cuda.synchronize()
        if not torch.equal(ham, ham_plain):
            raise AssertionError(f"Hamming kernel != plain version at {label}")
        dot = (x >= 0).float() * 2 - 1
        if not torch.equal((m - 2 * ham).float(), dot @ w_signs):
            raise AssertionError(f"Hamming kernel != the ±1 matmul at {label}")
        worst["hamming_matmul"] = max(worst["hamming_matmul"], (ham - ham_plain).abs().max().item())
        print(f"[kernels] {label}: fused == plain, hamming == plain == ±1 matmul", flush=True)
        if prepad or label.startswith("ragged"):
            continue

        name = label.split()[0]
        reps = _copies(wp.numel() * 4)
        w_sets = [wp] + [wp.clone() for _ in range(reps - 1)]
        lib_sets = [w_signs.to(torch.bfloat16)]
        lib_sets += [lib_sets[0].clone() for _ in range(_copies(m * n * 2) - 1)]
        x_pm = dot.to(torch.bfloat16)
        scale = alpha[None, :] * beta[:, None]

        f_ms = _time_ms(lambda w: fused_decode.fused_bnn_matmul_kernel(x, w, alpha, beta, m=m, n=n),
                        [(w,) for w in w_sets], 200)
        f_plain = _time_ms(lambda w: fused_decode.fused_bnn_matmul_plain(x, w, alpha, beta, m=m, n=n),
                           [(wp,)], 3)
        f_lib = _time_ms(lambda w: torch.matmul(x_pm, w).float() * scale, [(w,) for w in lib_sets], 50)
        h_ms = _time_ms(lambda w: xnor_matmul.hamming_matmul_packed(a, w, n=n),
                        [(w,) for w in w_sets], 200)
        h_plain = _time_ms(lambda w: xnor_matmul.hamming_matmul_plain(a, w), [(wp,)], 3)
        h_lib = _time_ms(lambda w: torch.matmul(x_pm, w), [(w,) for w in lib_sets], 50)

        popc = b * n * kw
        f_bytes = b * m * 2 + kw * n * 4 + n * 4 + b * 4 + b * n * 4
        h_bytes = b * kw * 4 + kw * n * 4 + b * n * 4
        for kname, ms, plain, lib, nbytes in (
            ("fused_bnn_matmul", f_ms, f_plain, f_lib, f_bytes),
            ("hamming_matmul", h_ms, h_plain, h_lib, h_bytes),
        ):
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = popc / popc_per_s * 1e3
            rec[kname][(name, b)] = {
                "ms": ms, "plain_ms": plain, "library_ms": lib,
                "bytes_ms": t_bytes, "ops_ms": t_ops,
            }
            print(f"[kernels] {kname} {name} B={b} (m={m}, n={n}): kernel {ms:.4f} ms, "
                  f"bound {max(t_bytes, t_ops):.4f} ms by "
                  f"{'bytes' if t_bytes >= t_ops else 'operations'} "
                  f"({nbytes} B, {popc} popc), plain {plain:.4f} ms, "
                  f"torch.matmul {lib:.4f} ms", flush=True)
    print(f"[kernels] fused_bnn_matmul check: torch.equal at every shape, max |diff| "
          f"{worst['fused_bnn_matmul']}; hamming_matmul check: torch.equal at every "
          f"shape, max |diff| {worst['hamming_matmul']}", flush=True)
    return {"records": rec, "worst": worst}


# flash attention cases (label, B, H, KV, Sq, Skv, D, causal): the
# tinyllama-1.1b prefill of the lockstep batch, a continuation of 64
# tokens over a 256-token graft, a ragged length, llama3.2-3b's heads
# (D = 128) and a non-causal square
FLASH_CASES = (
    ("tinyllama prefill", 8, 32, 4, 128, 128, 64, True),
    ("continuation 64 over 320", 1, 32, 4, 64, 320, 64, True),
    ("ragged 200", 2, 32, 4, 200, 200, 64, True),
    ("llama3.2-3b D=128", 1, 24, 8, 512, 512, 128, True),
    ("non-causal square", 1, 32, 4, 128, 128, 64, False),
)
# the main-path launch the summary line reports: one prefill layer
FLASH_MAIN = ("tinyllama prefill", "bf16")
# bitlinear / WDM MMM: the tinyllama-1.1b projection shapes (m, n)
MMA_SHAPES = {"w_qkv": (2048, 2560), "w1/w3": (2048, 5632), "w2": (5632, 2048)}
MMA_RAGGED = (9, 513, 3)  # rows, m, n
MMA_MAIN = ("w1/w3", 128)


def _visible_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs a causal mask leaves, with the queries at the
    last sq of the skv positions."""
    if not causal:
        return sq * skv
    diag = skv - sq
    return sum(min(skv, max(0, i + diag + 1)) for i in range(sq))


def _within(got, want, atol: float, rtol: float) -> tuple[bool, float]:
    import torch

    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return ok, diff.max().item()


def check_flash(gen) -> dict:
    """The flash kernel against its plain version on every case, in bf16
    and fp32; timings of kernel, plain version and SDPA. Tolerance: the
    two differ by summation order only (the q.k dot and the P.V sum in a
    tile), so fp32 agrees to 1e-5 and bf16 to one bf16 ulp (2^-7 of the
    value) where such a difference crosses a rounding boundary."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    rec, worst = {}, 0.0
    for label, b, h, kvh, sq, skv, d, causal in FLASH_CASES:
        for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, kvh, skv, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, kvh, skv, d), generator=gen, device="cuda").to(dtype)
            got = fa.flash_attention(q, k, v, causal=causal)
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            atol, rtol = (1e-5, 2.0**-7) if dtype == torch.bfloat16 else (1e-5, 1e-5)
            ok, err = _within(got, want, atol, rtol)
            if not ok or got.shape != want.shape:
                raise AssertionError(f"flash kernel != plain version at {label} {dname}: "
                                     f"max |diff| {err}")
            worst = max(worst, err)

            nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
            sets = [(q, k, v)] + [(q.clone(), k.clone(), v.clone())
                                  for _ in range(_copies(nbytes) - 1)]
            ms = _time_ms(lambda q_, k_, v_: fa.flash_attention(q_, k_, v_, causal=causal),
                          sets, 50)
            plain = _time_ms(lambda q_, k_, v_: fa.flash_attention_plain(q_, k_, v_, causal=causal),
                             sets[:1], 3)
            if causal and sq != skv:
                mask = torch.ones((sq, skv), dtype=torch.bool, device="cuda").tril(skv - sq)
                lib_fn = lambda q_, k_, v_: F.scaled_dot_product_attention(  # noqa: E731
                    q_, k_, v_, attn_mask=mask, enable_gqa=True)
            else:
                lib_fn = lambda q_, k_, v_: F.scaled_dot_product_attention(  # noqa: E731
                    q_, k_, v_, is_causal=causal, enable_gqa=True)
            lib = _time_ms(lib_fn, sets, 50)
            flops = 4 * b * h * _visible_pairs(sq, skv, causal) * d
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / (BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S) * 1e3
            rec[(label, dname)] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                                   "bytes_ms": t_bytes, "ops_ms": t_ops, "max_abs_err": err}
            print(f"[kernels] flash_attention {label} {dname} (B={b} H={h} KV={kvh} Sq={sq} "
                  f"Skv={skv} D={d} causal={causal}): kernel {ms:.4f} ms, bound "
                  f"{max(t_bytes, t_ops):.4f} ms by {'bytes' if t_bytes >= t_ops else 'operations'} "
                  f"({nbytes} B, {flops} FLOP), plain {plain:.4f} ms, SDPA {lib:.4f} ms; "
                  f"max |diff| vs plain {err:.3g}", flush=True)
    print(f"[kernels] flash_attention check: within tolerance at every case "
          f"(fp32 1e-5, bf16 one bf16 ulp; sum order only), max |diff| {worst}", flush=True)
    return {"records": rec, "worst": worst}


def _signs(gen, shape, dtype):
    import torch

    return torch.where(torch.randn(shape, generator=gen, device="cuda") >= 0, 1.0, -1.0).to(dtype)


def check_mma(gen) -> dict:
    """bitlinear and the WDM MMM against their plain versions at the
    tinyllama-1.1b projection shapes (8 and 128 rows) and a ragged case:
    ``torch.equal`` for ±1 operands (integer sums, exact in fp32), and
    the MMM on real-valued bf16 weights within the fp32 summation bound
    m * 2^-24 * sum|terms| (order only). Timings of kernel, plain version
    and ``torch.matmul`` on the bf16 operands."""
    import torch

    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import wdm_mmm as wm

    rec = {"bitlinear": {}, "wdm_mmm": {}}
    cases = [(name, rows, m, n) for name, (m, n) in MMA_SHAPES.items() for rows in (8, 128)]
    cases.append(("ragged", *MMA_RAGGED))
    for name, rows, m, n in cases:
        x = torch.randn((rows, m), generator=gen, device="cuda").to(torch.bfloat16)
        w = _signs(gen, (m, n), torch.bfloat16)
        alpha = torch.rand((n,), generator=gen, device="cuda") + 0.5
        a = _signs(gen, (rows, m), torch.bfloat16)
        checks = (
            ("bitlinear", bl.bitlinear_kernel(x, w, alpha), bl.bitlinear_plain(x, w, alpha)),
            ("wdm_mmm", wm.mmm(a, w), wm.mmm_plain(a, w)),
        )
        torch.cuda.synchronize()
        for kname, got, want in checks:
            if not torch.equal(got, want):
                raise AssertionError(f"{kname} kernel != plain version at {name} rows={rows}: "
                                     f"max |diff| {(got - want).abs().max().item()}")
        wr = torch.randn((m, n), generator=gen, device="cuda").to(torch.bfloat16)
        got, want = wm.mmm(a, wr), wm.mmm_plain(a, wr)
        bound = m * 2.0**-24 * (a.float().abs() @ wr.float().abs())
        torch.cuda.synchronize()
        real_err = (got - want).abs()
        if not bool((real_err <= bound).all()):
            raise AssertionError(f"wdm_mmm on real-valued weights beyond the summation bound "
                                 f"at {name} rows={rows}: max |diff| {real_err.max().item()}")
        print(f"[kernels] {name} rows={rows} (m={m}, n={n}): bitlinear == plain, wdm_mmm == "
              f"plain (±1); real-valued wdm_mmm max |diff| {real_err.max().item():.3g} within "
              f"m * 2^-24 * sum|terms|", flush=True)
        if name == "ragged":
            continue
        w_sets = [w] + [w.clone() for _ in range(_copies(m * n * 2) - 1)]
        xs_pm = torch.where(x >= 0, 1.0, -1.0).to(torch.bfloat16)
        t_ops = 2 * rows * m * n / BF16_FLOP_PER_S * 1e3
        for kname, fn, plain_fn, lib_fn, lhs_bytes in (
            ("bitlinear", lambda w_: bl.bitlinear_kernel(x, w_, alpha),
             lambda w_: bl.bitlinear_plain(x, w_, alpha),
             lambda w_: torch.matmul(xs_pm, w_), rows * m * 2 + n * 4),
            ("wdm_mmm", lambda w_: wm.mmm(a, w_), lambda w_: wm.mmm_plain(a, w_),
             lambda w_: torch.matmul(a, w_), rows * m * 2),
        ):
            ms = _time_ms(fn, [(w_,) for w_ in w_sets], 200)
            plain = _time_ms(plain_fn, [(w,)], 3)
            lib = _time_ms(lib_fn, [(w_,) for w_ in w_sets], 200)
            nbytes = lhs_bytes + m * n * 2 + rows * n * 4
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            rec[kname][(name, rows)] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                                        "bytes_ms": t_bytes, "ops_ms": t_ops}
            print(f"[kernels] {kname} {name} rows={rows} (m={m}, n={n}): kernel {ms:.4f} ms, "
                  f"bound {max(t_bytes, t_ops):.4f} ms by "
                  f"{'bytes' if t_bytes >= t_ops else 'operations'} ({nbytes} B, "
                  f"{2 * rows * m * n} FLOP), plain {plain:.4f} ms, torch.matmul {lib:.4f} ms",
                  flush=True)
    print("[kernels] bitlinear and wdm_mmm check: torch.equal at every shape, max |diff| 0",
          flush=True)
    return rec


def entry_point_phase(device: str = "cuda") -> dict:
    """The path of the two off-model kernels is their own entry point:
    ``ops.bitlinear`` and ``ops.wdm_mmm`` at the tinyllama-1.1b shapes,
    held to the dense oracles (``torch.equal`` on ±1 operands). Returns
    each kernel's launches in this run."""
    import torch

    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wdm_mmm as wm

    gen = torch.Generator(device=device).manual_seed(SEED + 1)

    def signs(shape):
        return torch.where(torch.randn(shape, generator=gen, device=device) >= 0, 1.0, -1.0)

    cases = [(rows, m, n) for m, n in MMA_SHAPES.values() for rows in (8, 128)] + [MMA_RAGGED]
    _reset_counts()
    for rows, m, n in cases:
        x = torch.randn((rows, m), generator=gen, device=device)
        w = signs((m, n))
        alpha = torch.rand((n,), generator=gen, device=device) + 0.5
        if not torch.equal(ops.bitlinear(x, w, alpha), ref.bitlinear_ref(x, w, alpha)):
            raise AssertionError(f"ops.bitlinear != bitlinear_ref at {(rows, m, n)}")
        g, kk = (rows // 8, 8) if rows % 8 == 0 else (1, rows)
        groups = signs((g, kk, m))
        if not torch.equal(ops.wdm_mmm(groups, w), ref.wdm_mmm_ref(groups, w)):
            raise AssertionError(f"ops.wdm_mmm != wdm_mmm_ref at {(rows, m, n)}")
    launches = {"bitlinear": bl.launches, "wdm_mmm": wm.launches}
    _check_launches(device, launches, {"bitlinear": len(cases), "wdm_mmm": len(cases)},
                    "entry points")
    print(f"[entry] ops.bitlinear and ops.wdm_mmm == dense oracles at {len(cases)} shapes; "
          f"launches {launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 4: serve tinyllama-1.1b at full width
# ---------------------------------------------------------------------------

ARCH = "tinyllama-1.1b"
BATCH, PROMPT, GEN, REQUESTS = 8, 128, 32, 16


def _reset_counts() -> None:
    from repro_torch.kernels import bitlinear, flash_attention, fused_decode, wdm_mmm, xnor_matmul

    for mod in (fused_decode, xnor_matmul, flash_attention, bitlinear, wdm_mmm):
        mod.launches = 0


def _counts() -> dict:
    from repro_torch.kernels import fused_decode, xnor_matmul

    return {"fused_bnn_matmul": fused_decode.launches, "hamming_matmul": xnor_matmul.launches}


def _release(res: dict) -> None:
    import torch

    res.pop("compiled", None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _check_launches(device: str, got: dict, want: dict, what: str) -> None:
    """Launch counts are kept for CUDA launches only (a CPU rehearsal of
    this phase runs the plain versions)."""
    if device == "cuda" and got != want:
        raise AssertionError(f"{what} launched {got}, expected {want}")


PROFILE_TICKS = 4


def profile_decode(compiled, tokens, tick_ms: float) -> None:
    """Where a decode tick's time goes: PROFILE_TICKS lockstep ticks under
    ``torch.profiler`` after an unprofiled prefill. Prints the host wall
    time per tick, the device time the profiler attributes to kernels
    and copies, their share of that wall time and of ``tick_ms`` (the
    same tick measured without the profiler), the device launches per
    tick and the kernels that take the most device time. A profiler
    that reports no device time prints "not measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import synchronize

    dev = compiled.device
    logits, pre = compiled.prefill(tokens)
    caches = compiled.graft_prefill_caches(
        compiled.init_cache(tokens.shape[0], tokens.shape[1] + PROFILE_TICKS), pre
    )
    tok = torch.argmax(logits, dim=-1)
    synchronize(dev)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_TICKS):
            logits, caches = compiled.decode_step(tok, tokens.shape[1] + i, caches)
            tok = torch.argmax(logits, dim=-1)
        synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_TICKS
    # device-side events only (kernels, copies): the host ops that launch
    # them carry the same device time again
    rows = [
        (getattr(e, "self_device_time_total", 0) / 1e3 / PROFILE_TICKS, e.count / PROFILE_TICKS, e.key)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    ]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    device_ms = sum(r[0] for r in rows)
    if not rows:
        print(f"[profile] decode tick {wall_ms:.2f} ms wall under the profiler; device "
              f"time not measured (the profiler reported none)", flush=True)
        return
    print(f"[profile] decode tick {wall_ms:.2f} ms wall under the profiler, device busy "
          f"{device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f}%, idle "
          f"{100 - 100 * device_ms / wall_ms:.1f}%); {100 * device_ms / tick_ms:.1f}% of the "
          f"{tick_ms:.2f} ms unprofiled tick; {sum(r[1] for r in rows):.0f} device launches "
          f"per tick", flush=True)
    for ms, count, name in rows[:8]:
        print(f"[profile]   {ms:.4f} ms/tick in {count:.0f} launches: {name[:90]}", flush=True)


def serve_phase(device: str = "cuda", smoke: bool = False) -> dict:
    """Drive the serve path; returns each kernel's launches in the run
    that exercises it (fused: the packed lockstep batch; Hamming: the
    same batch under --raw-weights). ``device="cpu", smoke=True``
    rehearses the phase on the CPU at the smoke config's size."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import compiler
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    layers = cfg.n_layers
    lock = ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT),
            "--gen", str(GEN), "--seed", str(SEED), "--device", device]
    lock += ["--smoke"] if smoke else []

    # a first, unmeasured run takes the process's one-time start-up costs
    # (CUDA context, library handles, kernel loads) out of the timed ones
    _release(serve.run(lock + ["--engine", "packed"]))
    _reset_counts()
    packed = serve.run(lock + ["--engine", "packed"])
    n_packed = _counts()
    logits = packed["prefill_logits"]
    if logits.shape != (BATCH, cfg.padded_vocab) or not torch.isfinite(logits[:, : cfg.vocab_size]).all():
        raise AssertionError(f"prefill logits of shape {tuple(logits.shape)} not finite")
    gen_packed = packed["generated"]
    if gen_packed.shape != (BATCH, GEN) or gen_packed.min() < 0 or gen_packed.max() >= cfg.vocab_size:
        raise AssertionError(f"generations of shape {gen_packed.shape} out of the vocab")
    # [q|k|v], o, w1, w3, w2 per layer, in the prefill and GEN - 1 ticks
    _check_launches(device, n_packed, {"fused_bnn_matmul": layers * 5 * GEN,
                                       "hamming_matmul": 0}, "packed lockstep")
    print(f"[serve] packed lockstep {ARCH} batch={BATCH} prompt={PROMPT} gen={GEN}: "
          f"prefill {packed['prefill_s'] * 1e3:.2f} ms, decode {GEN - 1} ticks "
          f"{packed['decode_s'] * 1e3:.2f} ms ({packed['decode_tok_s']:.1f} tok/s); "
          f"launches {n_packed}", flush=True)
    profile_decode(packed["compiled"], serve.prompts(cfg, BATCH, PROMPT, SEED),
                   packed["decode_s"] * 1e3 / (GEN - 1))
    _release(packed)

    _reset_counts()
    raw = serve.run(lock + ["--engine", "packed", "--raw-weights"])
    n_raw = _counts()
    # q, k, v, o, w1, w3, w2 per layer
    _check_launches(device, n_raw, {"fused_bnn_matmul": 0, "hamming_matmul": layers * 7 * GEN},
                    "raw-weights lockstep")
    if not np.array_equal(raw["generated"], gen_packed):
        raise AssertionError("raw-weights generations differ from the programmed ones")
    if not torch.equal(raw["prefill_logits"], logits):
        raise AssertionError("raw-weights prefill logits differ from the programmed ones")
    print(f"[serve] packed --raw-weights lockstep: prefill {raw['prefill_s'] * 1e3:.2f} ms, "
          f"decode {raw['decode_tok_s']:.1f} tok/s; launches {n_raw}; tokens and "
          f"prefill logits == programmed", flush=True)
    _release(raw)

    # the reference engine on the same weights and prompts, in BNN mode
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = lm.init_params(gen, cfg, device=device)
    ref_model = compiler.compile(
        dataclasses.replace(cfg, quant="bnn"), params,
        compiler.HardwareTarget(engine="reference"), device=device,
    )
    del params
    ref = serve.lockstep(ref_model, serve.prompts(cfg, BATCH, PROMPT, SEED), GEN)
    _release({"compiled": ref_model})
    del ref_model
    if not np.array_equal(ref["generated"], gen_packed):
        bad = int((ref["generated"] != gen_packed).sum())
        raise AssertionError(f"packed generations differ from reference in {bad} tokens")
    if not torch.equal(ref["prefill_logits"], logits):
        raise AssertionError("packed prefill logits differ from the reference engine's")
    print(f"[serve] reference lockstep: prefill {ref['prefill_s'] * 1e3:.2f} ms, decode "
          f"{ref['decode_tok_s']:.1f} tok/s; packed == reference: all {gen_packed.size} "
          f"tokens and the prefill logits bit for bit", flush=True)

    _reset_counts()
    req = serve.run(lock + ["--engine", "packed", "--requests", str(REQUESTS)])
    n_req = _counts()
    sch = req["stats"].scheduler
    if sch.finished != REQUESTS or any(len(s.generated) != GEN for s in req["states"]):
        raise AssertionError(f"request path finished {sch.finished} of {REQUESTS}")
    if device == "cuda" and (n_req["fused_bnn_matmul"] == 0 or n_req["hamming_matmul"] != 0):
        raise AssertionError(f"request path launched {n_req}")
    toks = sum(len(s.generated) for s in req["states"])
    print(f"[serve] request path: {REQUESTS} requests (prompts {PROMPT // 2}-{PROMPT}, gen "
          f"{GEN}) into {BATCH} slots in {req['wall_s'] * 1e3:.1f} ms ({toks / req['wall_s']:.1f} "
          f"tok/s), ticks={req['stats'].ticks}, prefills={req['stats'].prefills}; "
          f"launches {n_req}", flush=True)
    _release(req)
    return {"fused_bnn_matmul": n_packed["fused_bnn_matmul"],
            "hamming_matmul": n_raw["hamming_matmul"]}


def row_count_check(device: str = "cuda") -> dict:
    """Why the port pads and blocks its per-row ops: on the card a
    reduction or GEMM picks its layout by shape, so a row's result can
    depend on how many rows share the call, which would break batched ==
    alone and exact grafts. Reports the library ops as they are, and
    asserts the port's padded or blocked forms give equal bits."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import rowblock_matmul
    from repro_torch.models import layers

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    x = torch.randn((64, 2048), generator=gen, device=device)
    w = torch.randn((2048, 4096), generator=gen, device=device)
    q = torch.randn((8, 1, 32, 64), generator=gen, device=device).to(torch.bfloat16)
    kc, vc = (torch.randn((8, 160, 4, 64), generator=gen, device=device).to(torch.bfloat16)
              for _ in range(2))
    lens = torch.full((8,), 101, device=device)
    rows = (1, 2, 8, 15)

    def same(f, full, n):
        """Largest |difference| of the first r rows, computed alone,
        from the same rows inside the full call (0.0: equal bits)."""
        return max((f(r).float() - full[:r].float()).abs().max().item() for r in n)

    lib = {
        "mean": same(lambda r: (x[:r] * x[:r]).mean(-1), (x * x).mean(-1), rows),
        "fp32 matmul": same(lambda r: x[:r] @ w, x @ w, rows),
        "decode attention in one call": same(
            lambda r: layers._decode_block(q[:r], kc[:r], vc[:r], lens[:r]),
            layers._decode_block(q, kc, vc, lens), (1, 2, 4)),
    }
    port = {
        "ops.row_mean": same(lambda r: ops.row_mean(x[:r] * x[:r]), ops.row_mean(x * x), rows),
        "rowblock_matmul": same(lambda r: rowblock_matmul(x[:r], w, 0),
                                rowblock_matmul(x, w, 0), rows),
        "layers.decode_attention": same(
            lambda r: layers.decode_attention(q[:r], kc[:r], vc[:r], lens[:r]),
            layers.decode_attention(q, kc, vc, lens), (1, 2, 4)),
    }
    print(f"[rows] max |diff| of rows computed alone vs inside a larger call: library "
          f"{lib}; port {port}", flush=True)
    if any(port.values()):
        raise AssertionError(f"a padded or blocked per-row op depends on the row count: {port}")
    return port


# the prefix-graft workload: 4 shared 256-token prefixes, each request
# one of them plus a 32-96-token suffix, 32 tokens generated
FLEET_REQUESTS, FLEET_PREFIXES, PREFIX_LEN, SUFFIX = 16, 4, 256, (32, 96)
REQUEST_SEED = 1
CONT_PROMPT, CONT_CUT = 320, 256
# a suffix below 16 rows takes CUDA's other reduction layout unless the
# port pads it (ops.row_mean): the graft must stay exact there too
SHORT_SUFFIXES = (16, 8, 1)
# the flash path rounds attention differently from the plain-ops path (p
# stays fp32 for P.V where the plain path rounds p and v to bf16). One
# layer's attention at tinyllama's shapes is held to the reference's bf16
# flash tolerance (tests/test_flash_attention.py: 2e-2). Whole-model
# prefill logits are compared with full-precision projections (quant
# "none"; through binarized ones a flipped sign moves a logit by O(1)):
# each layer may move by one bf16 rounding of p and v, 2^-7 relative, so
# the bound is n_layers * 2^-7 * max|logit|. The binarized model's logit
# difference and token agreement are reported.
ATTN_TOL = 2e-2
LAYER_REL = 2.0**-7


def _flash_count() -> int:
    from repro_torch.kernels import flash_attention

    return flash_attention.launches


def fleet_requests(cfg) -> list:
    """The seeded shared-prefix request trace (``REQUEST_SEED``)."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(REQUEST_SEED)
    prefixes = rng.integers(0, cfg.vocab_size, size=(FLEET_PREFIXES, PREFIX_LEN))
    reqs = []
    for i in range(FLEET_REQUESTS):
        suffix = rng.integers(0, cfg.vocab_size, size=int(rng.integers(SUFFIX[0], SUFFIX[1] + 1)))
        prompt = np.concatenate([prefixes[i % FLEET_PREFIXES], suffix]).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=GEN))
    return reqs


def _timed_prefills(serving, log: list) -> None:
    """Wrap a serving engine's admission prefill to record (grafted
    tokens, ms) per admission, fenced by device synchronization."""
    from repro_torch.device import synchronize

    inner = serving.prefill_into

    def prefill_into(slot, st):
        graft = st.request.prefix
        synchronize(serving.device)
        t0 = time.perf_counter()
        inner(slot, st)
        synchronize(serving.device)
        log.append((graft.length if graft is not None else 0, (time.perf_counter() - t0) * 1e3))

    serving.prefill_into = prefill_into


def serve_pallas_phase(device: str = "cuda", smoke: bool = False) -> int:
    """The flash-attention path: tinyllama-1.1b with ``attn_impl="pallas"``
    through ``compile()``: (a) the lockstep batch on ``packed`` and
    ``reference`` (tokens and logits equal), and prefill logits against
    the plain-ops attention's within a stated bound; (b)
    ``CompiledModel.prefill_continue`` over the first 256 rows of a
    320-token prompt == ``prefill`` of the whole prompt, bit for bit, and
    so with 16-, 8- and 1-row suffixes, for both attention paths; (c) a
    2-replica fleet with prefix routing on the shared-prefix trace:
    grafts happen, every request's tokens equal a single engine's, and
    the flash kernel launched once per layer per prefill or continuation;
    (d) the single engine of 8 slots equals each request alone, for both
    attention paths. Returns the flash launches of the fleet run."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import compiler
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import synchronize
    from repro_torch.fleet import FleetEngine
    from repro_torch.launch import serve
    from repro_torch.models import layers as layers_lib
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config(ARCH) if smoke else get_config(ARCH),
                              attn_impl="pallas")
    layers = cfg.n_layers

    def params():
        return lm.init_params(torch.Generator(device=device).manual_seed(SEED), cfg,
                              device=device)

    packed = compiler.compile(cfg, params(), compiler.HardwareTarget(engine="packed"),
                              device=device)
    tokens = serve.prompts(cfg, BATCH, PROMPT, SEED)

    # (a) lockstep, packed and reference, both through the flash kernel
    serve.lockstep(packed, tokens, 2)  # warm-up: start-up costs out of the timed run
    _reset_counts()
    lock = serve.lockstep(packed, tokens, GEN)
    n_flash = _flash_count()
    if device == "cuda" and n_flash != layers:
        raise AssertionError(f"pallas lockstep launched flash {n_flash} times, expected {layers}")
    ref_model = compiler.compile(dataclasses.replace(cfg, quant="bnn"), params(),
                                 compiler.HardwareTarget(engine="reference"), device=device)
    ref = serve.lockstep(ref_model, tokens, GEN)
    del ref_model
    if not np.array_equal(ref["generated"], lock["generated"]):
        bad = int((ref["generated"] != lock["generated"]).sum())
        raise AssertionError(f"pallas: packed generations differ from reference in {bad} tokens")
    if not torch.equal(ref["prefill_logits"], lock["prefill_logits"]):
        raise AssertionError("pallas: packed prefill logits differ from the reference engine's")
    logits = lock["prefill_logits"]
    if not torch.isfinite(logits[:, : cfg.vocab_size]).all():
        raise AssertionError("pallas prefill logits not finite")
    jnp_model = compiler.compile(dataclasses.replace(cfg, attn_impl="jnp"), params(),
                                 compiler.HardwareTarget(engine="packed"), device=device)
    jnp_lock = serve.lockstep(jnp_model, tokens, GEN)
    del jnp_model
    bnn_diff = (logits - jnp_lock["prefill_logits"])[:, : cfg.vocab_size].abs().max().item()
    attn = [torch.randn((BATCH, PROMPT, n, cfg.hd), generator=torch.Generator(device=device)
                        .manual_seed(SEED + i), device=device).to(torch.bfloat16)
            for i, n in enumerate((cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))]
    pos = torch.arange(PROMPT, device=device)
    by_impl = [layers_lib.multi_head_attention(*attn, pos, pos, causal=True,
                                               chunk=cfg.attn_chunk, impl=impl)
               for impl in ("jnp", "pallas")]
    ok, attn_diff = _within(by_impl[1], by_impl[0], ATTN_TOL, ATTN_TOL)
    if not ok:
        raise AssertionError(f"one layer's attention, pallas vs jnp: max |diff| {attn_diff} "
                             f"beyond {ATTN_TOL}")
    fp = {}
    for impl in ("jnp", "pallas"):
        m_ = compiler.compile(dataclasses.replace(cfg, attn_impl=impl, quant="none"), params(),
                              compiler.HardwareTarget(engine="reference"), device=device)
        fp[impl] = m_.prefill(tokens)[0][:, : cfg.vocab_size].cpu()
        del m_
    fp_diff = (fp["pallas"] - fp["jnp"]).abs().max().item()
    fp_bound = layers * LAYER_REL * fp["jnp"].abs().max().item()
    if not fp_diff <= fp_bound:
        raise AssertionError(f"pallas vs jnp prefill logits (quant none): max |diff| {fp_diff} "
                             f"beyond n_layers * 2^-7 * max|logit| = {fp_bound}")
    same = int((jnp_lock["generated"] == lock["generated"]).sum())
    msg = (f"; vs attn_impl=jnp: one layer's attention max |diff| {attn_diff:.4g} (tol "
           f"{ATTN_TOL}), quant=none prefill logits max |diff| {fp_diff:.4g} (bound "
           f"{fp_bound:.4g}), binarized prefill logits max |diff| {bnn_diff:.4g}, tokens "
           f"equal in {same} of {jnp_lock['generated'].size}")
    print(f"[serve-pallas] lockstep {ARCH} batch={BATCH} prompt={PROMPT} gen={GEN}: prefill "
          f"{lock['prefill_s'] * 1e3:.2f} ms, decode {lock['decode_tok_s']:.1f} tok/s; packed "
          f"== reference: all {lock['generated'].size} tokens and the prefill logits; flash "
          f"launches {n_flash}{msg}", flush=True)

    # (b) continuation over a graft == the full prefill
    prompt = serve.prompts(cfg, 1, CONT_PROMPT, SEED + 2)
    packed.prefill(prompt)  # warm-up at these shapes
    synchronize(packed.device)
    t0 = time.perf_counter()
    full_logits, full = packed.prefill(prompt)
    synchronize(packed.device)
    full_ms = (time.perf_counter() - t0) * 1e3
    _, donor = packed.prefill(prompt[:, :CONT_CUT])
    packed.prefill_continue(prompt[:, CONT_CUT:], donor)
    synchronize(packed.device)
    t0 = time.perf_counter()
    cont_logits, cont = packed.prefill_continue(prompt[:, CONT_CUT:], donor)
    synchronize(packed.device)
    cont_ms = (time.perf_counter() - t0) * 1e3
    jnp_packed = compiler.compile(dataclasses.replace(cfg, attn_impl="jnp"), params(),
                                  compiler.HardwareTarget(engine="packed"), device=device)
    jnp_full = jnp_packed.prefill(prompt)
    for impl, model, (f_logits, f_caches) in (("pallas", packed, (full_logits, full)),
                                             ("jnp", jnp_packed, jnp_full)):
        for rows in (CONT_PROMPT - CONT_CUT, *SHORT_SUFFIXES):
            cut = CONT_PROMPT - rows
            if impl == "pallas" and cut == CONT_CUT:
                c_logits, c_caches = cont_logits, cont
            else:
                c_logits, c_caches = model.prefill_continue(prompt[:, cut:],
                                                            model.prefill(prompt[:, :cut])[1])
            if not torch.equal(c_logits, f_logits):
                raise AssertionError(f"{impl}: prefill_continue over {cut} tokens: logits != "
                                     f"prefill's")
            for slot, kv in f_caches.items():
                for key, t in kv.items():
                    if not torch.equal(c_caches[slot][key], t):
                        raise AssertionError(f"{impl}: prefill_continue over {cut} tokens: cache "
                                             f"{slot}/{key} != prefill's")
    del jnp_packed, jnp_full
    print(f"[serve-pallas] prefill_continue over {CONT_CUT} of {CONT_PROMPT} tokens == prefill "
          f"(logits and every cache, torch.equal), and with suffixes of "
          f"{', '.join(map(str, SHORT_SUFFIXES))} rows, for attn_impl pallas and jnp; full "
          f"prefill {full_ms:.2f} ms, continuation {cont_ms:.2f} ms", flush=True)
    del packed

    # (c) the fleet: two replicas on one card, prefix routing, two waves
    reqs = fleet_requests(cfg)
    max_len = PREFIX_LEN + SUFFIX[1] + GEN
    fleet = FleetEngine.build(cfg, params(), compiler.HardwareTarget(engine="packed"),
                              n_replicas=2, max_batch=BATCH, max_len=max_len,
                              routing="prefix", block_size=16, device=device)
    log: list = []
    for rep in fleet.replicas.values():
        _timed_prefills(rep.serving, log)
    _reset_counts()
    synchronize(torch.device(device))
    t0 = time.perf_counter()
    states = [fleet.submit(r) for r in reqs[:FLEET_PREFIXES]]  # wave 1: one per prefix
    fleet.step()
    for r in reqs[FLEET_PREFIXES:]:  # wave 2: one arrival per fleet tick
        states.append(fleet.submit(r))
        fleet.step()
    fleet.drain()
    synchronize(torch.device(device))
    wall = time.perf_counter() - t0
    n_fleet = _flash_count()
    fused = _counts()["fused_bnn_matmul"]
    st = fleet.stats()
    prefills = sum(r.prefills for r in st.replicas)
    if st.finished != FLEET_REQUESTS or st.grafted_tokens <= 0:
        raise AssertionError(f"fleet finished {st.finished} of {FLEET_REQUESTS}, grafted "
                             f"{st.grafted_tokens} tokens")
    if device == "cuda" and (n_fleet != layers * prefills or fused == 0):
        raise AssertionError(f"fleet launched flash {n_fleet} times for {prefills} prefills "
                             f"({layers} layers), fused {fused}")
    toks = sum(len(s.generated) for s in states)
    del fleet

    # (d) one engine of 8 slots, and each request alone, for both paths
    alone = {}
    for impl in ("pallas", "jnp"):
        model = compiler.compile(dataclasses.replace(cfg, attn_impl=impl), params(),
                                 compiler.HardwareTarget(engine="packed"), device=device)
        se = model.serve(max_batch=BATCH, max_len=max_len)
        single = [se.submit(r) for r in reqs]
        se.drain()
        if impl == "pallas":
            for f, s_ in zip(states, single):
                if tuple(f.generated) != tuple(s_.generated):
                    raise AssertionError(f"fleet request {f.request.rid} != single engine")
        for r, s_ in zip(reqs, single):
            se1 = model.serve(max_batch=1, max_len=max_len)
            st1 = se1.submit(r)
            se1.drain()
            if tuple(st1.generated) != tuple(s_.generated):
                raise AssertionError(f"{impl}: request {r.rid} in 8 slots != alone")
        alone[impl] = len(reqs)
        del model, se
    grafted = [ms for g, ms in log if g > 0]
    full_adm = [ms for g, ms in log if g == 0]
    print(f"[serve-pallas] fleet 2 replicas x {BATCH} slots, routing=prefix block=16: "
          f"{FLEET_REQUESTS} requests in {wall * 1e3:.1f} ms ({toks / wall:.1f} tok/s); "
          f"prefix hits {st.prefix_hits}, grafted {st.grafted_tokens} tokens, prefilled "
          f"{st.prefill_tokens}; prefill per admission: full {np.mean(full_adm):.2f} ms "
          f"({len(full_adm)}), grafted {np.mean(grafted):.2f} ms ({len(grafted)}); flash "
          f"launches {n_fleet} for {layers} layers x {prefills} prefills; tokens == single "
          f"engine; single engine == each request alone for all {alone['pallas']} (pallas) "
          f"and {alone['jnp']} (jnp)", flush=True)
    return n_fleet


def kernel_summary(checked: dict, launches: dict) -> list[dict]:
    """One entry per kernel: the sums over one tinyllama-1.1b layer's
    launches in a decode tick of 8 slots."""
    out = []
    for kname, layer, source, replaces in (
        ("fused_bnn_matmul", LAYER_FUSED, "src/repro_torch/kernels/csrc/fused_decode.cu",
         "src/repro/kernels/fused_decode.py:102"),
        ("hamming_matmul", LAYER_HAMMING, "src/repro_torch/kernels/csrc/xnor_matmul.cu",
         "src/repro/kernels/xnor_matmul.py:64"),
    ):
        recs = [checked["records"][kname][(s, 8)] for s in layer]
        t_bytes = sum(r["bytes_ms"] for r in recs)
        t_ops = sum(r["ops_ms"] for r in recs)
        out.append({
            "name": kname,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": checked["worst"][kname],
            "ms": sum(r["ms"] for r in recs),
            "plain_ms": sum(r["plain_ms"] for r in recs),
            "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) for r in recs),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in recs),
            "per": "one tinyllama-1.1b layer of a decode tick, 8 slots: "
                   + ", ".join(layer),
        })
    return out


def launch_summary(flash: dict, mma: dict, launches: dict) -> list[dict]:
    """One entry per kernel of this slice, per launch at its main shape:
    flash at one tinyllama-1.1b prefill layer (bf16), bitlinear and the
    WDM MMM at w1/w3 (2048 -> 5632) with 128 rows."""
    out = []
    for name, rec, err, source, replaces, per in (
        ("flash_attention", flash["records"][FLASH_MAIN], flash["worst"],
         "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:87",
         "one launch: a tinyllama-1.1b prefill layer, B=8 H=32 KV=4 S=128 D=64 causal, bf16"),
        ("bitlinear", mma["bitlinear"][MMA_MAIN], 0.0,
         "src/repro_torch/kernels/csrc/bitlinear.cu", "src/repro/kernels/bitlinear.py:42",
         "one launch: 128 rows x w1/w3 (2048 -> 5632)"),
        ("wdm_mmm", mma["wdm_mmm"][MMA_MAIN], 0.0,
         "src/repro_torch/kernels/csrc/wdm_mmm.cu", "src/repro/kernels/wdm_mmm.py:41",
         "one launch: 128 rows (G*K) x w1/w3 (2048 -> 5632)"),
    ):
        out.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": err,
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": max(rec["bytes_ms"], rec["ops_ms"]),
            "bound_by": "bytes" if rec["bytes_ms"] >= rec["ops_ms"] else "operations",
            "library_ms": rec["library_ms"],
            "per": per,
        })
    return out


def main() -> int:
    phase("device")
    card, clock_mhz = check_device()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    phase("build")
    build_kernels()
    phase("kernels")
    checked = check_kernels(clock_mhz)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash = check_flash(gen)
    mma = check_mma(gen)
    phase("entry points")
    launches = entry_point_phase()
    phase("serve")
    launches.update(serve_phase())
    phase("serve pallas")
    row_count_check()
    launches["flash_attention"] = serve_pallas_phase()
    summary = kernel_summary(checked, launches) + launch_summary(flash, mma, launches)
    print(json.dumps({"kernels": summary}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
