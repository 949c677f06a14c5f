#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--mma-only | --flash-only | --hamming-only | --fused-only |
                           --kernels-only | --telemetry-only | --simulators-only]

Each ``--*-only`` argument stops after those kernels' checks and timings
(``--kernels-only``: every kernel's; ``--telemetry-only`` and
``--simulators-only``: the build and that phase alone) and prints no
result line. Needs one
CUDA card (device 0), the CUDA toolkit's ``nvcc`` and ``nvidia-smi``;
exits non-zero without them. Phases, each announced on its own
``[phase]`` line:

1. device: card name and power limit, TF32 off for fp32 matmuls;
2. build: the five CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` each, all started together;
3. kernels: each kernel against its plain PyTorch version -- the fused
   BitLinear and Hamming kernels at the tinyllama-1.1b projection shapes
   with 8, 128 and 1024 rows, a ragged and three block-padded shapes
   (bit-exact, ``torch.equal``; each kernel's variant, ``b1`` or ``popc``,
   and plan printed, two launches equal), the fused kernel also at an
   edge shape (partial last word and k stage, n % 128 != 0) in bf16 and
   fp32, and -- with the ragged and block-padded shapes (``popc``), the
   Hamming kernel's words packed from them and bitlinear's ragged
   (``wmma``) and k-edge (``sm90``) shapes in bf16 and fp32 -- on signed
   zeros, NaN, subnormals of both signs and -2^-126, which must
   binarize as ``x > -2^-126`` (the JAX reference's ``x >= 0`` with
   subnormals read as zero), flash attention on
   prefill, continuation, ragged, D = 128 and non-causal cases in bf16
   (variant ``sm90``) and fp32 (``fma``), within a stated tolerance, two
   launches bit-identical, bitlinear and the WDM MMM at the projection shapes, a
   ragged shape (their WMMA variant) and an aligned shape with a partial
   last k tile (``torch.equal``; two launches bit-identical; each
   shape's variant and launch plan printed) -- with kernel, plain-version
   and one-PyTorch-call times and the card's bound (every kernel and its
   one-call yardstick timed by CUDA-graph replay, the kernel eagerly too);
4. entry points: ``ops.bitlinear`` / ``ops.wdm_mmm`` against the dense
   oracles, the path of those two kernels;
5. serve: tinyllama-1.1b at full width (random weights from a seeded
   generator) through ``repro_torch.launch.serve``: a lockstep batch on
   the ``packed`` engine, the same batch under ``--raw-weights`` and on
   the ``reference`` engine (tokens must match), and the request
   scheduler path. The kernels' launch counts (by variant: all ``b1``)
   are read around each run, and a few decode ticks
   run under ``torch.profiler`` to show where a tick's time goes;
6. serve pallas: the same model with ``attn_impl="pallas"`` -- lockstep,
   ``prefill_continue`` == ``prefill``, a 2-replica prefix-routed fleet,
   batched == alone, every flash launch of the ``sm90`` variant and every
   fused launch of ``b1`` -- after
   a check that the port's per-row ops give a row the same bits whatever
   the row count;
7. simulators: the paper's crossbar engines (``tacitmap``, ``wdm``,
   ``tiled`` on a tacitmap-policy plan of oPCM tiles, ``custbinarymap``)
   serving the same lockstep batch at full width: tokens == packed's,
   prefill logits == the reference engine's; ``wdm`` over flash, and
   with 8 requests in 8 slots == each alone (traced, with the
   measured-vs-modeled crosscheck); ``price()`` / ``describe()`` printed
   as the cost model's figures; per engine prefill ms, tok/s, device
   launches and ms per tick and peak memory on a ``{"simulators": ...}``
   JSON line;
8. telemetry: the request path (through the serve CLI's ``--trace-out``
   / ``--metrics-out``) and the fleet (inside ``obs.session()``) again
   with the port's telemetry on: tokens == the untraced runs above, one
   ``decode_tick`` span per tick and one ``prefill`` span per prefill,
   counters == the serving stats, a Chrome trace and metrics snapshot
   that parse (written under ``chiprun_out/telemetry``); prints the span
   medians and the traced and untraced tok/s.

Then one ``{"kernels": [...]}`` JSON line, the card line again, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import re
import statistics
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
# the binary tensor cores' rate (mma.sync m16n8k256 .and.popc), which no
# data sheet gives: measured by ``tools/tc_probe.py --sections b1`` on an
# H100 80GB HBM3 at 700 W (one bit-operation: one bit pair of the
# contraction); the operation bound of the Hamming and fused kernels
B1_BITOPS_PER_S = 5126e12
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
ROWS = (8, 128, 1024)  # a decode tick of 8 slots; one 128-token prompt; the lockstep
# prefill of 8 x 128 tokens (one call per projection)
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
    return card


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
        for fn, regs in _ptxas_report(_build.build_log(name)):
            print(f"[build] {name}: {fn}: {regs}", flush=True)


def _ptxas_report(log: str) -> list[tuple[str, str]]:
    """(kernel instance, ptxas's register / spill / shared-memory lines)
    from ``nvcc -Xptxas -v`` output, names demangled where ``c++filt`` is
    installed."""
    import re
    import shutil

    out, fn, facts = [], None, []
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            if fn is not None:
                out.append((fn, "; ".join(facts)))
            fn, facts = m.group(1), []
        elif fn is not None and ("registers" in line or "spill" in line):
            facts.append(line.split(":", 1)[-1].strip())
    if fn is not None:
        out.append((fn, "; ".join(facts)))
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(f for f, _ in out),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(names) == len(out):
            out = [(re.sub(r"\(.*", "", nm), facts) for nm, (_, facts) in zip(names, out)]
    return out


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


def packed_work(kname: str, rows: int, m: int, n: int) -> tuple[int, int]:
    """(bytes, bit-operations) of one fused BitLinear or Hamming launch at
    (rows, m) x (m, n): each input read once (bf16 x, or its packed
    words; the weight words; alpha and beta), the output (fp32, or int32
    Hamming sums) written once, and one bit-operation per bit pair of the
    packed contraction -- both kernels' b1 variants run it on the binary
    tensor cores (B1_BITOPS_PER_S)."""
    kw = -(-m // 32)
    if kname == "fused_bnn_matmul":
        activations = rows * m * 2 + n * 4 + rows * 4
    else:
        activations = rows * kw * 4
    return activations + kw * n * 4 + rows * n * 4, rows * n * kw * 32


def _check_fused(label: str, x, wp, alpha, beta, m: int, n: int, want_variant: str):
    """The fused kernel at one case: its plan's variant is ``want_variant``,
    two launches of that variant are ``torch.equal`` to each other and to
    the plain version. Returns (plan, max |diff|)."""
    import torch

    from repro_torch.kernels import fused_decode, mma_plan

    plan = mma_plan.choose_fused(x, wp, torch.empty((x.shape[0], n), device="cuda"), alpha,
                                 beta, m=m)
    before = dict(fused_decode.launches_by_variant)
    got = fused_decode.fused_bnn_matmul_kernel(x, wp, alpha, beta, m=m, n=n)
    again = fused_decode.fused_bnn_matmul_kernel(x, wp, alpha, beta, m=m, n=n)
    want = fused_decode.fused_bnn_matmul_plain(x, wp, alpha, beta, m=m, n=n)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = got != want
        raise AssertionError(f"fused kernel != plain version at {label} ({plan.describe()}): "
                             f"{int(bad.sum())} elements differ, first at "
                             f"{bad.nonzero()[0].tolist()}, max |diff| "
                             f"{(got - want).abs().nan_to_num(float('inf')).max().item()}")
    if not torch.equal(got, again):
        raise AssertionError(f"fused kernel: two launches differ at {label}")
    used = {v: fused_decode.launches_by_variant[v] - before[v] for v in before}
    if plan.variant != want_variant or used[want_variant] != 2:
        raise AssertionError(f"fused kernel at {label}: plan {plan.variant}, launches by "
                             f"variant {used}; expected {want_variant}")
    return plan, (got - want).abs().max().item()


# the fused kernel's edge shape (rows, m, n): b1 with a partial last word
# (2056 = 64 * 32 + 8), a partial last k stage (65 words: 8 stages and
# one word) and n % 128 != 0
FUSED_EDGE = (8, 2056, 264)

# signed zeros, NaN of both signs, bf16 subnormals of both signs (2^-133
# is bf16's least) and the least normal magnitude, each with the bit it
# binarizes to: x > -2^-126 (bnn.nonneg), which is x >= 0 with subnormals
# read as zero, as the JAX reference reads them under XLA
SPECIAL_BITS = ((0.0, 1), (-0.0, 1), (float("nan"), 0), (-float("nan"), 0),
                (2.0**-133, 1), (-(2.0**-133), 1), (3 * 2.0**-133, 1), (-3 * 2.0**-133, 1),
                (-(2.0**-126), 0))
SPECIAL_STRIDE = 11


def with_specials(x):
    """``x`` with SPECIAL_BITS' values at every SPECIAL_STRIDE-th feature
    (offset by kind) and -0.0 and NaN as its last two features, and the
    ±1 signs its features must binarize to (x's own sign elsewhere).
    Fails unless ``bnn.nonneg`` gives those signs."""
    import torch

    from repro_torch.core import bnn

    x = x.clone()
    signs = torch.where(x >= 0, 1.0, -1.0).to(x.dtype)  # x holds no special value yet
    for j, (v, bit) in enumerate(SPECIAL_BITS):
        x[:, j::SPECIAL_STRIDE] = v
        signs[:, j::SPECIAL_STRIDE] = 1.0 if bit else -1.0
    for j, (v, bit) in ((-1, (-0.0, 1)), (-2, (float("nan"), 0))):
        x[:, j] = v
        signs[:, j] = 1.0 if bit else -1.0
    if not torch.equal(torch.where(bnn.nonneg(x), 1.0, -1.0).to(x.dtype), signs):
        raise AssertionError("bnn.nonneg does not give the special values' bits")
    return x, signs


def check_fused_edges(gen) -> float:
    """The fused kernel at FUSED_EDGE with bf16 and fp32 x, and with x
    holding SPECIAL_BITS (with a finite beta passed in: mean|x| is NaN
    there) in bf16 and fp32: the b1 variant, two launches
    ``torch.equal``, ``torch.equal`` to the plain version, and on the
    special values ``torch.equal`` to its own launch on the signs those
    values must binarize to (-0.0 and subnormals +1, NaN and -2^-126 -1).
    Returns the largest |diff| (0.0)."""
    import torch

    from repro_torch.kernels import fused_decode

    rows, m, n = FUSED_EDGE
    worst = 0.0
    for label, dtype, special in (("bf16", torch.bfloat16, False), ("fp32", torch.float32, False),
                                  ("bf16 specials", torch.bfloat16, True),
                                  ("fp32 specials", torch.float32, True)):
        x, _, wp, alpha, beta = _case(gen, rows, m, n, False)
        x = x.to(dtype)
        if special:
            x, signs = with_specials(x)
            beta = torch.rand((rows,), generator=gen, device="cuda") + 0.5
        plan, err = _check_fused(f"edge {label}", x, wp, alpha, beta, m, n, "b1")
        worst = max(worst, err)
        if special:
            got = fused_decode.fused_bnn_matmul_kernel(x, wp, alpha, beta, m=m, n=n)
            want = fused_decode.fused_bnn_matmul_kernel(signs, wp, alpha, beta, m=m, n=n)
            if not torch.equal(got, want):
                raise AssertionError(f"fused kernel at edge {label}: the special values do not "
                                     f"binarize as x > -2^-126")
        print(f"[kernels] fused_bnn_matmul edge m={m} n={n} B={rows} {label}: == plain, two "
              f"launches equal{'; specials binarize as x > -2^-126' if special else ''}; "
              f"{plan.describe()}", flush=True)
    return worst


def check_kernels(which: tuple[str, ...] = ("fused_bnn_matmul", "hamming_matmul")) -> dict:
    """The fused BitLinear and Hamming kernels (those in ``which``) against
    their plain versions at every shape (``torch.equal``); returns
    per-kernel, per-shape records for the summary line. Kernel and
    ``torch.matmul`` are timed by CUDA-graph replay (the card's time),
    the kernel also eagerly (CUDA events around a loop of calls: the
    wrapper's host work included), the plain version eagerly."""
    import torch

    from repro_torch.core import bnn
    from repro_torch.kernels import fused_decode, mma_plan, ops, xnor_matmul

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [(f"{name} B={b}", b, m, n, False) for name, (m, n) in SHAPES.items() for b in ROWS]
    cases += [("ragged m=100 n=48 B=3", 3, 100, 48, False),
              ("prepad m=100 n=48 B=3", 3, 100, 48, True),
              # a padded artifact with n % 4 != 0: the b1 variant's
              # element-wise store
              ("prepad m=100 n=45 B=3", 3, 100, 45, True),
              ("prepad m=300 n=200 B=8", 8, 300, 200, True)]
    rec = {k: {} for k in which}
    worst = dict.fromkeys(which, 0.0)
    if "fused_bnn_matmul" in which:
        worst["fused_bnn_matmul"] = check_fused_edges(gen)
    for label, b, m, n, prepad in cases:
        x, w_signs, wp, alpha, beta = _case(gen, b, m, n, prepad)
        if prepad or label.startswith("ragged"):
            # the popc variant's cases (and the Hamming kernel's words
            # packed from them) on SPECIAL_BITS, with a finite beta
            x, _ = with_specials(x)
            beta = torch.rand((b,), generator=gen, device="cuda") + 0.5
            label += " specials"
        kw = -(-m // 32)
        a = ops.pack_bits(bnn.nonneg(x))
        plan_text = ""
        if "fused_bnn_matmul" in which:
            # the projection shapes take b1; the ragged and block-padded
            # ones (bf16 rows of 200 or 600 bytes) popc
            fplan, err = _check_fused(label, x, wp, alpha, beta, m, n,
                                      "popc" if m in (100, 300) else "b1")
            worst["fused_bnn_matmul"] = max(worst["fused_bnn_matmul"], err)
            plan_text = f"; fused {fplan.describe()}"
        dot = bnn.nonneg(x).float() * 2 - 1
        if "hamming_matmul" in which:
            plan = mma_plan.choose_hamming(a, wp, torch.empty((b, n), dtype=torch.int32,
                                                              device="cuda"))
            # every shape takes the b1 variant but m = 300 (10 words a row:
            # a row stride TMA cannot describe)
            want_variant = "popc" if m == 300 else "b1"
            before = dict(xnor_matmul.launches_by_variant)
            ham = xnor_matmul.hamming_matmul_packed(a, wp, n=n)
            again = xnor_matmul.hamming_matmul_packed(a, wp, n=n)
            ham_plain = xnor_matmul.hamming_matmul_plain(a, wp[:kw, :n])
            torch.cuda.synchronize()
            if not torch.equal(ham, ham_plain):
                raise AssertionError(f"Hamming kernel != plain version at {label} "
                                     f"({plan.describe()})")
            if not torch.equal(ham, again):
                raise AssertionError(f"Hamming kernel: two launches differ at {label}")
            if not torch.equal((m - 2 * ham).float(), dot @ w_signs):
                raise AssertionError(f"Hamming kernel != the ±1 matmul at {label}")
            used = {v: xnor_matmul.launches_by_variant[v] - before[v] for v in before}
            if plan.variant != want_variant or used[want_variant] != 2:
                raise AssertionError(f"Hamming kernel at {label}: plan {plan.variant}, launches "
                                     f"by variant {used}; expected {want_variant}")
            worst["hamming_matmul"] = max(worst["hamming_matmul"],
                                          (ham - ham_plain).abs().max().item())
            plan_text += f"; Hamming {plan.describe()}"
        print(f"[kernels] {label}: {' and '.join(which)} == plain"
              f"{' == ±1 matmul, two launches equal' if 'hamming_matmul' in which else ''}"
              f"{plan_text}", flush=True)
        if prepad or label.startswith("ragged"):
            continue

        name = label.split()[0]
        reps = _copies(wp.numel() * 4)
        w_sets = [(wp,)] + [(wp.clone(),) for _ in range(reps - 1)]
        lib_sets = [w_signs.to(torch.bfloat16)]
        lib_sets = [(w,) for w in lib_sets + [lib_sets[0].clone() for _ in range(_copies(m * n * 2) - 1)]]
        x_pm = dot.to(torch.bfloat16)
        scale = alpha[None, :] * beta[:, None]
        runs = {
            "fused_bnn_matmul": (
                lambda w: fused_decode.fused_bnn_matmul_kernel(x, w, alpha, beta, m=m, n=n),
                lambda w: fused_decode.fused_bnn_matmul_plain(x, w, alpha, beta, m=m, n=n),
                lambda w: torch.matmul(x_pm, w).float() * scale),
            "hamming_matmul": (
                lambda w: xnor_matmul.hamming_matmul_packed(a, w, n=n),
                lambda w: xnor_matmul.hamming_matmul_plain(a, w),
                lambda w: torch.matmul(x_pm, w)),
        }
        for kname in which:
            fn, plain_fn, lib_fn = runs[kname]
            ms = _graph_ms(fn, w_sets, 200)
            eager = _time_ms(fn, w_sets, 200)
            plain = _time_ms(plain_fn, w_sets[:1], 3)
            lib = _graph_ms(lib_fn, lib_sets, 200)
            nbytes, bit_ops = packed_work(kname, b, m, n)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, bit_ops / B1_BITOPS_PER_S * 1e3
            rec[kname][(name, b)] = {
                "ms": ms, "eager_ms": eager, "plain_ms": plain, "library_ms": lib,
                "bytes_ms": t_bytes, "ops_ms": t_ops,
            }
            print(f"[kernels] {kname} {name} B={b} (m={m}, n={n}): kernel {ms:.4f} ms "
                  f"(graph replay; eager {eager:.4f} ms), bound {max(t_bytes, t_ops):.4f} ms by "
                  f"{'bytes' if t_bytes >= t_ops else 'operations'} "
                  f"({nbytes} B, {bit_ops} bit-operations; "
                  f"{100 * max(t_bytes, t_ops) / ms:.0f}% of it), plain {plain:.4f} ms, "
                  f"torch.matmul {lib:.4f} ms (graph replay)"
                  f"{'; ' + fplan.describe() if kname == 'fused_bnn_matmul' else ''}", flush=True)
    print("[kernels] " + "; ".join(f"{k} check: torch.equal at every shape, max |diff| "
                                    f"{worst[k]}" for k in which), flush=True)
    return {"records": rec, "worst": worst}


# flash attention cases (label, B, H, KV, Sq, Skv, D, causal): the
# tinyllama-1.1b prefill of the lockstep batch, a continuation of 64
# tokens over a 256-token graft, a ragged length, llama3.2-3b's heads
# (D = 128), a non-causal square and a short non-causal ragged case
FLASH_CASES = (
    ("tinyllama prefill", 8, 32, 4, 128, 128, 64, True),
    ("continuation 64 over 320", 1, 32, 4, 64, 320, 64, True),
    ("ragged 200", 2, 32, 4, 200, 200, 64, True),
    ("llama3.2-3b D=128", 1, 24, 8, 512, 512, 128, True),
    ("non-causal square", 1, 32, 4, 128, 128, 64, False),
    # fewer queries than a tile over a ragged key length: the masked edge
    # tile without a diagonal
    ("non-causal 40 over 100", 2, 8, 2, 40, 100, 64, False),
)
# the main-path launch the summary line reports: one prefill layer
FLASH_MAIN = ("tinyllama prefill", "bf16")
# bitlinear / WDM MMM: the tinyllama-1.1b projection shapes (m, n)
MMA_SHAPES = {"w_qkv": (2048, 2560), "w1/w3": (2048, 5632), "w2": (5632, 2048)}
MMA_RAGGED = (9, 513, 3)  # rows, m, n: the WMMA variant (n % 8 != 0)
MMA_EDGE = (8, 2056, 264)  # the sm90 variant, m not a multiple of its 64 k tile
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
    and fp32; timings of kernel and SDPA by CUDA-graph replay, of the
    kernel eagerly too, and of the plain version. Tolerance: the
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
            # bf16 takes the tensor-core variant, fp32 the FMA one
            want_variant = "sm90" if dtype == torch.bfloat16 else "fma"
            before = dict(fa.launches_by_variant)
            got = fa.flash_attention(q, k, v, causal=causal)
            again = fa.flash_attention(q, k, v, causal=causal)
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            atol, rtol = (1e-5, 2.0**-7) if dtype == torch.bfloat16 else (1e-5, 1e-5)
            ok, err = _within(got, want, atol, rtol)
            if not ok or got.shape != want.shape:
                raise AssertionError(f"flash kernel ({want_variant}) != plain version at {label} "
                                     f"{dname}: max |diff| {err}")
            if not torch.equal(got, again):
                raise AssertionError(f"flash kernel: two launches differ at {label} {dname}")
            used = {k_: fa.launches_by_variant[k_] - before[k_] for k_ in before}
            if fa.choose_variant(q, k, v) != want_variant or used[want_variant] != 2:
                raise AssertionError(f"flash at {label} {dname}: launches by variant {used}; "
                                     f"expected {want_variant}")
            worst = max(worst, err)

            nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
            sets = [(q, k, v)] + [(q.clone(), k.clone(), v.clone())
                                  for _ in range(_copies(nbytes) - 1)]
            kernel_fn = lambda q_, k_, v_: fa.flash_attention(q_, k_, v_, causal=causal)  # noqa: E731
            ms = _graph_ms(kernel_fn, sets, 50)
            eager = _time_ms(kernel_fn, sets, 50)
            plain = _time_ms(lambda q_, k_, v_: fa.flash_attention_plain(q_, k_, v_, causal=causal),
                             sets[:1], 3)
            if causal and sq != skv:
                mask = torch.ones((sq, skv), dtype=torch.bool, device="cuda").tril(skv - sq)
                lib_fn = lambda q_, k_, v_: F.scaled_dot_product_attention(  # noqa: E731
                    q_, k_, v_, attn_mask=mask, enable_gqa=True)
            else:
                lib_fn = lambda q_, k_, v_: F.scaled_dot_product_attention(  # noqa: E731
                    q_, k_, v_, is_causal=causal, enable_gqa=True)
            lib = _graph_ms(lib_fn, sets, 50)
            flops = 4 * b * h * _visible_pairs(sq, skv, causal) * d
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / (BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S) * 1e3
            rec[(label, dname)] = {"ms": ms, "eager_ms": eager, "plain_ms": plain,
                                   "library_ms": lib, "bytes_ms": t_bytes, "ops_ms": t_ops,
                                   "max_abs_err": err}
            bound = max(t_bytes, t_ops)
            print(f"[kernels] flash_attention {label} {dname} (B={b} H={h} KV={kvh} Sq={sq} "
                  f"Skv={skv} D={d} causal={causal}): kernel {ms:.4f} ms (graph replay; eager "
                  f"{eager:.4f} ms), bound {bound:.4f} ms by "
                  f"{'bytes' if t_bytes >= t_ops else 'operations'} ({nbytes} B, {flops} FLOP; "
                  f"{100 * bound / ms:.0f}% of it), plain {plain:.4f} ms, SDPA {lib:.4f} ms "
                  f"(graph replay); variant {want_variant}, max |diff| vs plain {err:.3g}, two "
                  f"launches bit-identical", flush=True)
    print(f"[kernels] flash_attention check: within tolerance at every case "
          f"(fp32 1e-5, bf16 one bf16 ulp; sum order only), max |diff| {worst}", flush=True)
    return {"records": rec, "worst": worst}


def _signs(gen, shape, dtype):
    import torch

    return torch.where(torch.randn(shape, generator=gen, device="cuda") >= 0, 1.0, -1.0).to(dtype)


def _graph_ms(fn, arg_sets, iters: int) -> float:
    """Mean ms per launch of ``fn(*args)`` on the card alone: one CUDA graph
    captures ``iters`` launches cycling through ``arg_sets`` (weight copies
    past the 50 MB L2) and is replayed between two CUDA events, so the
    wrapper's per-call host work is not timed."""
    import torch

    for args in arg_sets[: min(3, len(arg_sets))]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def _plan_line(kname: str, plan, clusters) -> str:
    text = f"{kname} {plan.describe()}"
    if clusters is not None:
        text += f", {clusters} such clusters resident at once (need {plan.ctas // plan.split})"
    return text


def check_mma(gen) -> dict:
    """bitlinear and the WDM MMM against their plain versions at the
    tinyllama-1.1b projection shapes (8 and 128 rows), a ragged case (the
    WMMA variant) and an aligned case whose m is not a multiple of the 64
    k tile (the sm90 variant's zero-filled edge and bitlinear's k mask):
    ``torch.equal`` for ±1 operands (integer sums, exact in fp32), the MMM
    on real-valued bf16 weights within the fp32 summation bound
    m * 2^-24 * sum|terms| (order only), and two launches of each kernel
    bit-identical (the split-K reduction's fixed order). Prints each
    shape's variant and plan. Times kernel and ``torch.matmul`` on the
    bf16 operands by CUDA-graph replay (the card's time) and the kernel
    also eagerly (CUDA events around a loop of calls, as the other
    kernels are timed), and the plain version."""
    import torch

    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import mma_plan
    from repro_torch.kernels import wdm_mmm as wm

    rec = {"bitlinear": {}, "wdm_mmm": {}}
    cases = [(name, rows, m, n) for name, (m, n) in MMA_SHAPES.items() for rows in (8, 128)]
    cases += [("ragged", *MMA_RAGGED), ("k-edge", *MMA_EDGE)]
    for name, rows, m, n in cases:
        x = torch.randn((rows, m), generator=gen, device="cuda").to(torch.bfloat16)
        w = _signs(gen, (m, n), torch.bfloat16)
        alpha = torch.rand((n,), generator=gen, device="cuda") + 0.5
        a = _signs(gen, (rows, m), torch.bfloat16)
        wr = torch.randn((m, n), generator=gen, device="cuda").to(torch.bfloat16)
        out = torch.empty((rows, n), device="cuda")
        plans = {"bitlinear": mma_plan.choose(x, w, out, alpha), "wdm_mmm": mma_plan.choose(a, w, out)}
        want_variant = "wmma" if name == "ragged" else "sm90"
        before = {k: dict(mod.launches_by_variant) for k, mod in (("bitlinear", bl), ("wdm_mmm", wm))}
        runs = (
            ("bitlinear", lambda: bl.bitlinear_kernel(x, w, alpha), bl.bitlinear_plain(x, w, alpha)),
            ("wdm_mmm", lambda: wm.mmm(a, w), wm.mmm_plain(a, w)),
        )
        for kname, fn, want in runs:
            got, again = fn(), fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{kname} kernel != plain version at {name} rows={rows}: "
                                     f"max |diff| {(got - want).abs().max().item()}")
            if not torch.equal(got, again):
                raise AssertionError(f"{kname}: two launches differ at {name} rows={rows}")
        got, again, want = wm.mmm(a, wr), wm.mmm(a, wr), wm.mmm_plain(a, wr)
        bound = m * 2.0**-24 * (a.float().abs() @ wr.float().abs())
        torch.cuda.synchronize()
        real_err = (got - want).abs()
        if not bool((real_err <= bound).all()):
            raise AssertionError(f"wdm_mmm on real-valued weights beyond the summation bound "
                                 f"at {name} rows={rows}: max |diff| {real_err.max().item()}")
        if not torch.equal(got, again):
            raise AssertionError(f"wdm_mmm on real-valued weights: two launches differ at "
                                 f"{name} rows={rows}")
        for kname, mod in (("bitlinear", bl), ("wdm_mmm", wm)):
            used = {v: mod.launches_by_variant[v] - before[kname][v] for v in before[kname]}
            want_used = 2 + (kname == "wdm_mmm") * 2
            if plans[kname].variant != want_variant or used[want_variant] != want_used:
                raise AssertionError(f"{kname} at {name} rows={rows}: plan {plans[kname].variant}, "
                                     f"launches by variant {used}; expected {want_variant}")
        specials = ""
        if name in ("ragged", "k-edge"):
            # bitlinear's binarize (the wmma variant's, and the sm90
            # variant's bf16 sign trick and fp32 comparison) on
            # SPECIAL_BITS: == plain, and == its own launch on the signs
            for dtype in (torch.bfloat16, torch.float32):
                xs, signs = with_specials(x.to(dtype))
                plan = mma_plan.choose(xs, w, out, alpha)
                got = bl.bitlinear_kernel(xs, w, alpha)
                if plan.variant != want_variant or not torch.equal(
                        got, bl.bitlinear_plain(xs, w, alpha)) or not torch.equal(
                        got, bl.bitlinear_kernel(signs, w, alpha)):
                    raise AssertionError(f"bitlinear ({plan.variant}) at {name} rows={rows} "
                                         f"{dtype}: the special values do not binarize as "
                                         f"x > -2^-126")
            specials = "; bitlinear on the special values (bf16, fp32) == plain == its signs"
        clusters = {
            "bitlinear": bl.max_active_clusters(plans["bitlinear"], x.dtype),
            "wdm_mmm": wm.max_active_clusters(plans["wdm_mmm"]),
        } if want_variant == "sm90" else {"bitlinear": None, "wdm_mmm": None}
        print(f"[kernels] {name} rows={rows} (m={m}, n={n}): bitlinear == plain, wdm_mmm == "
              f"plain (±1); real-valued wdm_mmm max |diff| {real_err.max().item():.3g} within "
              f"m * 2^-24 * sum|terms|; two launches bit-identical (both kernels, real-valued "
              f"MMM too){specials}", flush=True)
        for kname in ("bitlinear", "wdm_mmm"):
            print(f"[kernels]   {_plan_line(kname, plans[kname], clusters[kname])}", flush=True)
        if name in ("ragged", "k-edge"):
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
            sets = [(w_,) for w_ in w_sets]
            ms = _graph_ms(fn, sets, 200)
            eager = _time_ms(fn, sets, 200)
            plain = _time_ms(plain_fn, [(w,)], 3)
            lib = _graph_ms(lib_fn, sets, 200)
            nbytes = lhs_bytes + m * n * 2 + rows * n * 4
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            plan = plans[kname]
            rec[kname][(name, rows)] = {"ms": ms, "eager_ms": eager, "plain_ms": plain,
                                        "library_ms": lib, "bytes_ms": t_bytes, "ops_ms": t_ops,
                                        "ctas": plan.ctas, "split": plan.split}
            print(f"[kernels] {kname} {name} rows={rows} (m={m}, n={n}): kernel {ms:.4f} ms "
                  f"(graph replay; eager {eager:.4f} ms), bound {max(t_bytes, t_ops):.4f} ms by "
                  f"{'bytes' if t_bytes >= t_ops else 'operations'} ({nbytes} B, "
                  f"{2 * rows * m * n} FLOP; {100 * max(t_bytes, t_ops) / ms:.0f}% of it), "
                  f"plain {plain:.4f} ms, torch.matmul {lib:.4f} ms (graph replay); "
                  f"{plan.variant}, {plan.ctas} CTAs, split {plan.split}, {plan.stages} stages",
                  flush=True)
    print("[kernels] bitlinear and wdm_mmm check: torch.equal at every shape, max |diff| 0; "
          "two launches bit-identical at every shape", flush=True)
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
    variants = {"bitlinear": dict(bl.launches_by_variant), "wdm_mmm": dict(wm.launches_by_variant)}
    _check_launches(device, launches, {"bitlinear": len(cases), "wdm_mmm": len(cases)},
                    "entry points")
    # the six projection shapes take the sm90 variant, the ragged one WMMA
    by_variant = {"sm90": len(cases) - 1, "wmma": 1}
    _check_launches(device, variants, {"bitlinear": by_variant, "wdm_mmm": by_variant},
                    "entry points by variant")
    BY_VARIANT.update(variants)
    print(f"[entry] ops.bitlinear and ops.wdm_mmm == dense oracles at {len(cases)} shapes; "
          f"launches {launches}, by variant {variants}", flush=True)
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
    for mod in (fused_decode, xnor_matmul, flash_attention, bitlinear, wdm_mmm):
        mod.launches_by_variant = dict.fromkeys(mod.launches_by_variant, 0)


# each kernel's launches by variant in the run that counts its launches
# (filled by the phases)
BY_VARIANT: dict[str, dict[str, int]] = {}
# the lockstep batch's packed tokens and reference-engine prefill logits
# per attention path, {"jnp" | "pallas": {"tokens", "logits"}} (filled by
# the serve phases; the simulators phase holds every engine to them)
BASELINE: dict[str, dict] = {}
# the untraced runs of the traces the telemetry phase traces again:
# {"requests" | "fleet": {"tokens": {rid: tokens}, "tok_s": ...}} (filled
# by the serve phases)
UNTRACED: dict[str, dict] = {}


def _counts() -> dict:
    from repro_torch.kernels import fused_decode, xnor_matmul

    return {"fused_bnn_matmul": fused_decode.launches, "hamming_matmul": xnor_matmul.launches}


def _fused_variants() -> dict[str, int]:
    from repro_torch.kernels import fused_decode

    return dict(fused_decode.launches_by_variant)


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
    from repro_torch.kernels import xnor_matmul
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
    # every projection's activations and words have strides TMA can describe
    fused_variants = _fused_variants()
    _check_launches(device, {"fused_bnn_matmul": fused_variants},
                    {"fused_bnn_matmul": {"popc": 0, "b1": layers * 5 * GEN}},
                    "packed lockstep by variant")
    BY_VARIANT["fused_bnn_matmul"] = fused_variants
    print(f"[serve] packed lockstep {ARCH} batch={BATCH} prompt={PROMPT} gen={GEN}: "
          f"prefill {packed['prefill_s'] * 1e3:.2f} ms, decode {GEN - 1} ticks "
          f"{packed['decode_s'] * 1e3:.2f} ms ({packed['decode_tok_s']:.1f} tok/s); "
          f"launches {n_packed}, fused by variant {fused_variants}", flush=True)
    profile_decode(packed["compiled"], serve.prompts(cfg, BATCH, PROMPT, SEED),
                   packed["decode_s"] * 1e3 / (GEN - 1))
    _release(packed)

    _reset_counts()
    raw = serve.run(lock + ["--engine", "packed", "--raw-weights"])
    n_raw = _counts()
    # q, k, v, o, w1, w3, w2 per layer
    _check_launches(device, n_raw, {"fused_bnn_matmul": 0, "hamming_matmul": layers * 7 * GEN},
                    "raw-weights lockstep")
    # every projection's packed words have a row stride TMA can describe
    ham_variants = dict(xnor_matmul.launches_by_variant)
    _check_launches(device, {"hamming_matmul": ham_variants},
                    {"hamming_matmul": {"popc": 0, "b1": layers * 7 * GEN}},
                    "raw-weights lockstep by variant")
    BY_VARIANT["hamming_matmul"] = ham_variants
    if not np.array_equal(raw["generated"], gen_packed):
        raise AssertionError("raw-weights generations differ from the programmed ones")
    if not torch.equal(raw["prefill_logits"], logits):
        raise AssertionError("raw-weights prefill logits differ from the programmed ones")
    print(f"[serve] packed --raw-weights lockstep: prefill {raw['prefill_s'] * 1e3:.2f} ms, "
          f"decode {raw['decode_tok_s']:.1f} tok/s; launches {n_raw}, by variant "
          f"{ham_variants}; tokens and "
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
    BASELINE["jnp"] = {"tokens": gen_packed, "logits": ref["prefill_logits"]}
    print(f"[serve] reference lockstep: prefill {ref['prefill_s'] * 1e3:.2f} ms, decode "
          f"{ref['decode_tok_s']:.1f} tok/s; packed == reference: all {gen_packed.size} "
          f"tokens and the prefill logits bit for bit", flush=True)

    _reset_counts()
    req = serve.run(lock + ["--engine", "packed", "--requests", str(REQUESTS)])
    n_req = _counts()
    req_variants = _fused_variants()
    sch = req["stats"].scheduler
    if sch.finished != REQUESTS or any(len(s.generated) != GEN for s in req["states"]):
        raise AssertionError(f"request path finished {sch.finished} of {REQUESTS}")
    if device == "cuda" and (n_req["fused_bnn_matmul"] == 0 or n_req["hamming_matmul"] != 0
                             or req_variants != {"popc": 0, "b1": n_req["fused_bnn_matmul"]}):
        raise AssertionError(f"request path launched {n_req}, fused by variant {req_variants}")
    toks = sum(len(s.generated) for s in req["states"])
    UNTRACED["requests"] = {"tokens": {s.rid: tuple(s.generated) for s in req["states"]},
                            "tok_s": toks / req["wall_s"]}
    print(f"[serve] request path: {REQUESTS} requests (prompts {PROMPT // 2}-{PROMPT}, gen "
          f"{GEN}) into {BATCH} slots in {req['wall_s'] * 1e3:.1f} ms ({toks / req['wall_s']:.1f} "
          f"tok/s), ticks={req['stats'].ticks}, prefills={req['stats'].prefills}; "
          f"launches {n_req}, fused by variant {req_variants}", flush=True)
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


def _flash_variants() -> dict[str, int]:
    from repro_torch.kernels import flash_attention

    return dict(flash_attention.launches_by_variant)


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


def build_fleet(cfg, params, device: str):
    """The 2-replica prefix-routed fleet of the shared-prefix trace."""
    from repro_torch import compiler
    from repro_torch.fleet import FleetEngine

    return FleetEngine.build(cfg, params, compiler.HardwareTarget(engine="packed"),
                             n_replicas=2, max_batch=BATCH,
                             max_len=PREFIX_LEN + SUFFIX[1] + GEN, routing="prefix",
                             block_size=16, device=device)


def drive_fleet(fleet, reqs, device: str) -> tuple[list, float]:
    """Serve the shared-prefix trace in two waves (one request per prefix,
    then one arrival per fleet tick, so later arrivals find the prefix
    library filled); returns the states and the wall seconds, the
    clock ending in a device synchronization."""
    import torch

    from repro_torch.device import synchronize

    synchronize(torch.device(device))
    t0 = time.perf_counter()
    states = [fleet.submit(r) for r in reqs[:FLEET_PREFIXES]]  # wave 1: one per prefix
    fleet.step()
    for r in reqs[FLEET_PREFIXES:]:  # wave 2: one arrival per fleet tick
        states.append(fleet.submit(r))
        fleet.step()
    fleet.drain()
    synchronize(torch.device(device))
    return states, time.perf_counter() - t0


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
    # bf16 (B, H, S, D) views of the model's activations: the sm90 variant
    _check_launches(device, {"flash": n_flash, "by variant": _flash_variants(),
                             "fused by variant": _fused_variants()},
                    {"flash": layers, "by variant": {"fma": 0, "sm90": layers},
                     "fused by variant": {"popc": 0, "b1": layers * 5 * GEN}},
                    "pallas lockstep")
    ref_model = compiler.compile(dataclasses.replace(cfg, quant="bnn"), params(),
                                 compiler.HardwareTarget(engine="reference"), device=device)
    ref = serve.lockstep(ref_model, tokens, GEN)
    del ref_model
    if not np.array_equal(ref["generated"], lock["generated"]):
        bad = int((ref["generated"] != lock["generated"]).sum())
        raise AssertionError(f"pallas: packed generations differ from reference in {bad} tokens")
    if not torch.equal(ref["prefill_logits"], lock["prefill_logits"]):
        raise AssertionError("pallas: packed prefill logits differ from the reference engine's")
    BASELINE["pallas"] = {"tokens": lock["generated"], "logits": ref["prefill_logits"]}
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
    fleet = build_fleet(cfg, params(), device)
    _reset_counts()
    states, wall = drive_fleet(fleet, reqs, device)
    n_fleet = _flash_count()
    fused = _counts()["fused_bnn_matmul"]
    st = fleet.stats()
    prefills = sum(r.prefills for r in st.replicas)
    if st.finished != FLEET_REQUESTS or st.grafted_tokens <= 0:
        raise AssertionError(f"fleet finished {st.finished} of {FLEET_REQUESTS}, grafted "
                             f"{st.grafted_tokens} tokens")
    fleet_variants = _flash_variants()
    fleet_fused = _fused_variants()
    if device == "cuda" and (n_fleet != layers * prefills or fused == 0
                             or fleet_variants != {"fma": 0, "sm90": n_fleet}
                             or fleet_fused != {"popc": 0, "b1": fused}):
        raise AssertionError(f"fleet launched flash {n_fleet} times ({fleet_variants}) for "
                             f"{prefills} prefills ({layers} layers), fused {fused} "
                             f"({fleet_fused})")
    BY_VARIANT["flash_attention"] = fleet_variants
    toks = sum(len(s.generated) for s in states)
    UNTRACED["fleet"] = {"tokens": {s.request.rid: tuple(s.generated) for s in states},
                         "tok_s": toks / wall}
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
    print(f"[serve-pallas] fleet 2 replicas x {BATCH} slots, routing=prefix block=16: "
          f"{FLEET_REQUESTS} requests in {wall * 1e3:.1f} ms ({toks / wall:.1f} tok/s); "
          f"prefix hits {st.prefix_hits}, grafted {st.grafted_tokens} tokens, prefilled "
          f"{st.prefill_tokens}; flash "
          f"launches {n_fleet} for {layers} layers x {prefills} prefills, by variant "
          f"{fleet_variants}; fused launches {fused}, by variant {fleet_fused}; tokens == single "
          f"engine; single engine == each request alone for all {alone['pallas']} (pallas) "
          f"and {alone['jnp']} (jnp)", flush=True)
    return n_fleet


# ---------------------------------------------------------------------------
# phase 7: the crossbar simulators
# ---------------------------------------------------------------------------

# the paper's engines at tinyllama-1.1b full width: (engine, target fields)
SIMULATORS = (
    ("tacitmap", {}),                                       # ePCM tiles
    ("wdm", {}),                                            # oPCM, K = 16 clamped to 8
    ("tiled", {"mapping_policy": "tacitmap", "spec": "oPCM"}),
    ("custbinarymap", {}),                                  # ePCM 2T2R rows
)
# the wdm engine, 8 slots vs each request alone: the first SIM_REQUESTS
# requests of the serve phase's trace, SIM_GEN tokens each
SIM_REQUESTS, SIM_GEN = 8, 8


def _baseline(cfg, impl: str, device: str) -> dict:
    """The packed lockstep tokens and the reference engine's prefill
    logits on ``impl`` attention: the serve phases' (kept in BASELINE),
    or computed here when this phase runs alone."""
    import dataclasses

    import torch

    from repro_torch import compiler
    from repro_torch.launch import serve
    from repro_torch.models import lm

    if impl not in BASELINE:
        cfg = dataclasses.replace(cfg, attn_impl=impl)
        tokens = serve.prompts(cfg, BATCH, PROMPT, SEED)
        runs = {}
        for engine in ("packed", "reference"):
            params = lm.init_params(torch.Generator(device=device).manual_seed(SEED), cfg,
                                    device=device)
            model = compiler.compile(dataclasses.replace(cfg, quant="bnn"), params,
                                     compiler.HardwareTarget(engine=engine), device=device)
            runs[engine] = serve.lockstep(model, tokens, GEN)
            del model, params
        BASELINE[impl] = {"tokens": runs["packed"]["generated"],
                          "logits": runs["reference"]["prefill_logits"]}
    return BASELINE[impl]


def _tick_launches(compiled, tokens) -> tuple[float, float]:
    """(device launches, device ms) per decode tick: two lockstep ticks
    under ``torch.profiler`` after an unprofiled prefill."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import synchronize

    ticks = 2
    logits, pre = compiled.prefill(tokens)
    caches = compiled.graft_prefill_caches(
        compiled.init_cache(tokens.shape[0], tokens.shape[1] + ticks), pre)
    tok = torch.argmax(logits, dim=-1)
    synchronize(compiled.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(ticks):
            logits, caches = compiled.decode_step(tok, tokens.shape[1] + i, caches)
            tok = torch.argmax(logits, dim=-1)
        synchronize(compiled.device)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in events) / ticks,
            sum(getattr(e, "self_device_time_total", 0) for e in events) / 1e3 / ticks)


SIMULATORS_OUT = ROOT / "chiprun_out" / "simulators"


def simulators_phase(device: str = "cuda", smoke: bool = False,
                     out_dir: Path = SIMULATORS_OUT) -> dict:
    """The paper's crossbar simulators at tinyllama-1.1b full width and
    depth through ``compile()``: ``tacitmap`` (ePCM), ``wdm`` (oPCM, K =
    16 clamped to the 8 slots), ``tiled`` (a plan compiled under the
    tacitmap policy on oPCM tiles) and ``custbinarymap`` (ePCM). Each
    serves the lockstep batch of the serve phase (8 prompts of 128, 31
    decode ticks, jnp attention): its tokens must equal the packed
    engine's and its prefill logits the reference engine's, bit for bit.
    Then ``wdm`` once more over the flash kernel (``attn_impl="pallas"``:
    tokens == packed's over flash, one flash launch per layer, all
    ``sm90``), ``wdm`` with 8 requests in 8 slots (traced: the
    measured-vs-modeled crosscheck printed) == each request alone, and
    ``price()`` / ``describe()`` of the compiled model, the cost model's
    figures for an ePCM/oPCM crossbar, printed as modeled (the full
    ``describe()`` table in ``out_dir/describe.txt``). Prints one
    ``{"simulators": ...}`` JSON line: per engine prefill ms, decode
    tok/s, device launches and ms per tick, peak device memory. One
    engine's model is programmed at a time and released. Returns that
    line's object."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import compiler, obs
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.crossbar import OPCM_TILE
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import Request

    t_phase = time.perf_counter()
    cfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    layers = cfg.n_layers
    on_card = device == "cuda"
    tokens = serve.prompts(cfg, BATCH, PROMPT, SEED)

    def params(c):
        return lm.init_params(torch.Generator(device=device).manual_seed(SEED), c, device=device)

    def target(engine, kw):
        kw = dict(kw)
        if kw.pop("spec", None) == "oPCM":
            kw["spec"] = OPCM_TILE
        return compiler.HardwareTarget(engine=engine, **kw)

    def check(engine, impl, run, want):
        if not np.array_equal(run["generated"], want["tokens"]):
            bad = int((run["generated"] != want["tokens"]).sum())
            raise AssertionError(f"{engine} ({impl}): tokens differ from packed's in {bad}")
        if not torch.equal(run["prefill_logits"], want["logits"]):
            raise AssertionError(f"{engine} ({impl}): prefill logits != the reference engine's")

    rows = []
    want = _baseline(cfg, "jnp", device)
    for engine, kw in SIMULATORS:
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        model = compiler.compile(cfg, params(cfg), target(engine, kw), device=device)
        serve.lockstep(model, tokens, 2)  # warm-up: this engine's first shapes
        _reset_counts()
        run = serve.lockstep(model, tokens, GEN)
        launched = {**_counts(), "flash_attention": _flash_count()}
        _check_launches(device, launched, dict.fromkeys(launched, 0), f"{engine} lockstep")
        check(engine, "jnp", run, want)
        per_tick, tick_ms = _tick_launches(model, tokens) if on_card else (None, None)
        row = {
            "engine": engine,
            "spec": model.spec.technology,
            "k": model.group_size_for(BATCH),
            "programmed": model.programmed,
            "program_ms": model.program_s * 1e3,
            "prefill_ms": run["prefill_s"] * 1e3,
            "decode_tok_s": run["decode_tok_s"],
            "launches_per_tick": per_tick,
            "device_ms_per_tick": tick_ms,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
        }
        rows.append(row)
        device_line = (f"{per_tick:.0f} device launches and {tick_ms:.3f} device ms per tick, "
                       f"peak {row['peak_mem_gib']:.2f} GiB" if on_card else
                       "device launches, device time and peak memory not measured (CPU)")
        print(f"[simulators] {engine} ({row['spec']}, K={row['k']}) lockstep {ARCH} batch="
              f"{BATCH} prompt={PROMPT} gen={GEN}: prefill {row['prefill_ms']:.2f} ms, decode "
              f"{row['decode_tok_s']:.1f} tok/s, {device_line}; tokens == packed, prefill "
              f"logits == reference", flush=True)
        if engine == "tiled":
            # the cost model's figures for the plan's crossbar; the
            # per-layer table goes to a file, its summary lines here
            described = model.describe()
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / "describe.txt").write_text(described + "\n")
            for line in described.splitlines():
                if line.startswith(("[target]", "[mapping]", "[price]")):
                    print(f"[simulators] modeled, not measured: {line}", flush=True)
            print(f"[simulators] modeled, not measured: "
                  f"{model.price(n_active=BATCH).summary()} (n_active={BATCH})", flush=True)
        del model, run
    _release({})

    # wdm over the flash kernel
    pcfg = dataclasses.replace(cfg, attn_impl="pallas")
    want = _baseline(cfg, "pallas", device)
    model = compiler.compile(pcfg, params(pcfg), target("wdm", {}), device=device)
    _reset_counts()
    run = serve.lockstep(model, tokens, GEN)
    launched = {**_counts(), "flash_attention": _flash_count()}
    _check_launches(device, {**launched, "flash by variant": _flash_variants()},
                    {"fused_bnn_matmul": 0, "hamming_matmul": 0, "flash_attention": layers,
                     "flash by variant": {"fma": 0, "sm90": layers}}, "wdm over flash")
    check("wdm", "pallas", run, want)
    rows.append({"engine": "wdm", "attn_impl": "pallas", "prefill_ms": run["prefill_s"] * 1e3,
                 "decode_tok_s": run["decode_tok_s"], "launches": launched})
    print(f"[simulators] wdm over flash: prefill {run['prefill_s'] * 1e3:.2f} ms, decode "
          f"{run['decode_tok_s']:.1f} tok/s; tokens == packed over flash, prefill logits == "
          f"reference; launches {launched}, flash by variant {_flash_variants()}", flush=True)
    del model, run
    _release({})

    # wdm: 8 requests in 8 slots (traced) == each alone; the crosscheck
    model = compiler.compile(cfg, params(cfg), target("wdm", {}), device=device)
    rng = np.random.default_rng(REQUEST_SEED)
    trace = serve.prompts(cfg, SIM_REQUESTS, PROMPT, SEED)
    reqs = [Request(rid=i, prompt=trace[i, : int(rng.integers(PROMPT // 2, PROMPT + 1))]
                    .astype(np.int32), max_new_tokens=SIM_GEN) for i in range(SIM_REQUESTS)]
    max_len = PROMPT + SIM_GEN
    with obs.session() as tel:
        se = model.serve(max_batch=BATCH, max_len=max_len)
        states = [se.submit(r) for r in reqs]
        se.drain()
        checks = obs.crosscheck_serving(se)
    if se.group_k != BATCH or not all(len(st.generated) == SIM_GEN for st in states):
        raise AssertionError(f"wdm requests: K={se.group_k}, generated "
                             f"{[len(st.generated) for st in states]}")
    for r, st in zip(reqs, states):
        one = model.serve(max_batch=1, max_len=max_len)
        alone = one.submit(r)
        one.drain()
        if tuple(alone.generated) != tuple(st.generated):
            raise AssertionError(f"wdm: request {r.rid} in {BATCH} slots != alone")
    if not checks or not all(c.finite for c in checks):
        raise AssertionError(f"wdm crosscheck rows {checks}")
    print(f"[simulators] wdm requests: {SIM_REQUESTS} requests in {BATCH} slots (K="
          f"{se.group_k}) == each alone, {SIM_GEN} tokens each; measured-vs-modeled "
          f"decode-tick pricing (modeled: the cost model's oPCM crossbar; measured: this "
          f"device):", flush=True)
    print(obs.format_report(checks), flush=True)
    del model, se
    _release({})

    seconds = time.perf_counter() - t_phase
    out = {"simulators": rows, "seconds": seconds}
    print(json.dumps(out), flush=True)
    print(f"[simulators] phase {seconds:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8: telemetry
# ---------------------------------------------------------------------------

TELEMETRY_OUT = ROOT / "chiprun_out" / "telemetry"
_PROM_SAMPLE = re.compile(r'^[a-z_]+(\{([a-z_]+="[^"]*",?)+\})? -?[0-9.e+inf]+$')


def _median_ms(spans) -> float:
    return statistics.median(s.duration_s * 1e3 for s in spans) if spans else float("nan")


def _counter(tel, name: str) -> float:
    inst = tel.metrics.get(name)
    return inst.value if inst is not None else 0.0


def _check_exports(out: Path, what: str) -> None:
    """``out``'s Chrome trace must be JSON with ``traceEvents`` and every
    line of its metrics snapshot a Prometheus comment or sample."""
    trace, metrics = out / "trace.json", out / "metrics.txt"
    if not json.loads(trace.read_text())["traceEvents"]:
        raise AssertionError(f"{what}: the Chrome trace has no events")
    bad = [line for line in metrics.read_text().splitlines()
           if not (line.startswith(("# HELP ", "# TYPE ")) or _PROM_SAMPLE.match(line))]
    if bad:
        raise AssertionError(f"{what}: metrics lines that do not parse: {bad[:3]}")


def _check_serving_telemetry(tel, stats: dict, what: str) -> None:
    """Span counts and counters against the serving stats: one
    ``decode_tick`` span per tick, one ``prefill`` span per prefill with
    the grafted tokens summed, and the tick, token, group, pad-lane and
    prefill counters equal to the stats' totals."""
    ticks, prefills = tel.tracer.spans("decode_tick"), tel.tracer.spans("prefill")
    got = {
        "decode_tick spans": len(ticks),
        "prefill spans": len(prefills),
        "grafted in prefill spans": sum(s.attrs["grafted"] for s in prefills),
        "repro_decode_ticks_total": _counter(tel, "repro_decode_ticks_total"),
        "repro_decoded_tokens_total": _counter(tel, "repro_decoded_tokens_total"),
        "repro_mmm_groups_total": _counter(tel, "repro_mmm_groups_total"),
        "repro_pad_lanes_total": _counter(tel, "repro_pad_lanes_total"),
        "repro_prefills_total": _counter(tel, "repro_prefills_total"),
        "tick latency observations": tel.metrics.histogram("repro_tick_latency_seconds").total,
    }
    want = {
        "decode_tick spans": stats["ticks"], "prefill spans": stats["prefills"],
        "grafted in prefill spans": stats["grafted"],
        "repro_decode_ticks_total": stats["ticks"], "repro_decoded_tokens_total": stats["decoded"],
        "repro_mmm_groups_total": stats["mmm_groups"], "repro_pad_lanes_total": stats["pad_lanes"],
        "repro_prefills_total": stats["prefills"], "tick latency observations": stats["ticks"],
    }
    if got != want:
        raise AssertionError(f"{what}: telemetry {got} != stats {want}")


def _span_shares(tel, wall_s: float) -> str:
    """The share of a traced run's wall time inside prefill and
    decode_tick spans (the rest: scheduling, routing, token emission)."""
    pre = sum(s.duration_s for s in tel.tracer.spans("prefill"))
    tick = sum(s.duration_s for s in tel.tracer.spans("decode_tick"))
    return (f"prefill spans {pre * 1e3:.1f} ms ({100 * pre / wall_s:.1f}%), decode_tick spans "
            f"{tick * 1e3:.1f} ms ({100 * tick / wall_s:.1f}%), outside both "
            f"{100 * (1 - (pre + tick) / wall_s):.1f}% of {wall_s * 1e3:.1f} ms")


def telemetry_phase(device: str = "cuda", smoke: bool = False, out: Path = TELEMETRY_OUT) -> dict:
    """The port's own telemetry on the two request traces, each run once
    more with a session on: (a) the request path through the serve CLI's
    ``--trace-out`` / ``--metrics-out`` (16 requests, jnp attention, 8
    slots); (b) the 2-replica prefix-routed fleet (``attn_impl="pallas"``)
    inside ``obs.session()``. Each traced run must give the tokens of
    the untraced run of the same trace (the serve phases' runs, or its
    own when run alone), one span per tick and per prefill, counters
    equal to the stats, a Chrome trace and metrics snapshot that parse,
    and its fused launches all ``b1`` (the fleet's flash launches all
    ``sm90``). Prints the span medians (compile.program, prefill full and
    grafted, decode_tick), the spans' share of each run's wall time and
    the traced and untraced tok/s. Returns those numbers."""
    import dataclasses

    import torch

    from repro_torch import obs
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    base = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    layers = base.n_layers
    lock = ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT),
            "--gen", str(GEN), "--seed", str(SEED), "--device", device, "--engine", "packed"]
    lock += ["--smoke"] if smoke else []
    req_args = lock + ["--requests", str(REQUESTS)]
    result = {}

    # (a) the request path, traced through the CLI's flags
    if "requests" not in UNTRACED:  # run alone: warm up, then the untraced run
        _release(serve.run(lock + ["--gen", "2"]))
        plain = serve.run(req_args)
        UNTRACED["requests"] = {
            "tokens": {s.rid: tuple(s.generated) for s in plain["states"]},
            "tok_s": sum(len(s.generated) for s in plain["states"]) / plain["wall_s"]}
        _release(plain)
    (out / "requests").mkdir(parents=True, exist_ok=True)
    _reset_counts()
    traced = serve.run(req_args + ["--trace-out", str(out / "requests" / "trace.json"),
                                   "--metrics-out", str(out / "requests" / "metrics.txt")])
    n_fused, fused = _counts()["fused_bnn_matmul"], _fused_variants()
    tel = traced["telemetry"]
    if obs.enabled() or tel is None:
        raise AssertionError("the serve CLI left its telemetry session open or made none")
    _check_exports(out / "requests", "request path")
    tokens = {s.rid: tuple(s.generated) for s in traced["states"]}
    if tokens != UNTRACED["requests"]["tokens"]:
        bad = sorted(r for r in tokens if tokens[r] != UNTRACED["requests"]["tokens"].get(r))
        raise AssertionError(f"request path: traced tokens differ from untraced for {bad}")
    st = traced["stats"]
    _check_serving_telemetry(tel, {"ticks": st.ticks, "prefills": st.prefills,
                                   "grafted": st.grafted_tokens, "decoded": st.decoded,
                                   "mmm_groups": st.mmm_groups, "pad_lanes": st.pad_lanes},
                             "request path")
    sched = {"repro_requests_submitted_total": _counter(tel, "repro_requests_submitted_total"),
             "ttft observations": tel.metrics.histogram("repro_ttft_ticks").total}
    if sched != {"repro_requests_submitted_total": REQUESTS, "ttft observations": REQUESTS}:
        raise AssertionError(f"request path: scheduler telemetry {sched}")
    if device == "cuda" and (n_fused == 0 or fused != {"popc": 0, "b1": n_fused}):
        raise AssertionError(f"traced request path launched fused {n_fused} ({fused})")
    toks = sum(len(s.generated) for s in traced["states"])
    req = {
        "compile.program ms": _median_ms(tel.tracer.spans("compile.program")),
        "prefill ms": _median_ms(tel.tracer.spans("prefill")),
        "decode_tick ms": _median_ms(tel.tracer.spans("decode_tick")),
        "traced tok/s": toks / traced["wall_s"],
        "untraced tok/s": UNTRACED["requests"]["tok_s"],
    }
    print(f"[telemetry] request path, {REQUESTS} requests into {BATCH} slots: traced tokens == "
          f"untraced; {len(tel.tracer.spans('decode_tick'))} decode_tick spans == ticks, "
          f"{len(tel.tracer.spans('prefill'))} prefill spans == prefills, counters == stats; "
          f"medians: compile.program {req['compile.program ms']:.2f} ms, prefill "
          f"{req['prefill ms']:.2f} ms, decode_tick {req['decode_tick ms']:.2f} ms; "
          f"{_span_shares(tel, traced['wall_s'])}; {req['traced tok/s']:.1f} tok/s traced, "
          f"{req['untraced tok/s']:.1f} untraced; fused launches {fused}", flush=True)
    result["requests"] = req
    _release(traced)

    # (b) the fleet, traced inside a session from compile() on
    cfg = dataclasses.replace(base, attn_impl="pallas")
    reqs = fleet_requests(cfg)

    def params():
        return lm.init_params(torch.Generator(device=device).manual_seed(SEED), cfg,
                              device=device)

    if "fleet" not in UNTRACED:
        fleet = build_fleet(cfg, params(), device)
        states, wall = drive_fleet(fleet, reqs, device)
        UNTRACED["fleet"] = {"tokens": {s.request.rid: tuple(s.generated) for s in states},
                             "tok_s": sum(len(s.generated) for s in states) / wall}
        del fleet, states
    with obs.session() as tel:
        fleet = build_fleet(cfg, params(), device)
        _reset_counts()
        states, wall = drive_fleet(fleet, reqs, device)
        n_flash, flash = _flash_count(), _flash_variants()
        n_fused, fused = _counts()["fused_bnn_matmul"], _fused_variants()
    (out / "fleet").mkdir(parents=True, exist_ok=True)
    tel.write(trace_out=str(out / "fleet" / "trace.json"),
              jsonl_out=str(out / "fleet" / "trace.jsonl"),
              metrics_out=str(out / "fleet" / "metrics.txt"))
    _check_exports(out / "fleet", "fleet")
    tokens = {s.request.rid: tuple(s.generated) for s in states}
    if tokens != UNTRACED["fleet"]["tokens"]:
        bad = sorted(r for r in tokens if tokens[r] != UNTRACED["fleet"]["tokens"].get(r))
        raise AssertionError(f"fleet: traced tokens differ from untraced for {bad}")
    fs = fleet.stats()
    _check_serving_telemetry(tel, {
        "ticks": fs.ticks, "prefills": sum(r.prefills for r in fs.replicas),
        "grafted": fs.grafted_tokens, "decoded": fs.decoded,
        "mmm_groups": sum(r.mmm_groups for r in fs.replicas),
        "pad_lanes": sum(r.pad_lanes for r in fs.replicas)}, "fleet")
    routing = {"repro_fleet_routed_total": _counter(tel, "repro_fleet_routed_total"),
               "repro_fleet_prefix_hits_total": _counter(tel, "repro_fleet_prefix_hits_total")}
    if routing != {"repro_fleet_routed_total": FLEET_REQUESTS,
                   "repro_fleet_prefix_hits_total": fs.prefix_hits} or fs.grafted_tokens <= 0:
        raise AssertionError(f"fleet: routing telemetry {routing}, stats hits {fs.prefix_hits}, "
                             f"grafted {fs.grafted_tokens}")
    prefills = sum(r.prefills for r in fs.replicas)
    if device == "cuda" and (n_flash != layers * prefills or flash != {"fma": 0, "sm90": n_flash}
                             or n_fused == 0 or fused != {"popc": 0, "b1": n_fused}):
        raise AssertionError(f"traced fleet launched flash {n_flash} ({flash}) for {prefills} "
                             f"prefills, fused {n_fused} ({fused})")
    pre = tel.tracer.spans("prefill")
    toks = sum(len(s.generated) for s in states)
    flt = {
        "compile.program ms": _median_ms(tel.tracer.spans("compile.program")),
        "prefill full ms": _median_ms([s for s in pre if s.attrs["grafted"] == 0]),
        "prefill grafted ms": _median_ms([s for s in pre if s.attrs["grafted"] > 0]),
        "decode_tick ms": _median_ms(tel.tracer.spans("decode_tick")),
        "traced tok/s": toks / wall,
        "untraced tok/s": UNTRACED["fleet"]["tok_s"],
    }
    n_grafted = sum(1 for s in pre if s.attrs["grafted"] > 0)
    print(f"[telemetry] fleet, 2 replicas x {BATCH} slots, flash: traced tokens == untraced; "
          f"{len(tel.tracer.spans('decode_tick'))} decode_tick spans == ticks, {len(pre)} prefill "
          f"spans == prefills ({n_grafted} grafted, {fs.grafted_tokens} tokens == FleetStats), "
          f"counters == stats; medians: compile.program {flt['compile.program ms']:.2f} ms "
          f"(2 replicas), prefill full {flt['prefill full ms']:.2f} ms ({len(pre) - n_grafted}) "
          f"vs grafted {flt['prefill grafted ms']:.2f} ms ({n_grafted}), decode_tick "
          f"{flt['decode_tick ms']:.2f} ms; {_span_shares(tel, wall)}; {flt['traced tok/s']:.1f} "
          f"tok/s traced, {flt['untraced tok/s']:.1f} untraced; flash launches {flash}, fused "
          f"{fused}", flush=True)
    result["fleet"] = flt
    del fleet
    _release({})
    return result


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
            "eager_ms": sum(r["eager_ms"] for r in recs),
            "launches_by_variant": BY_VARIANT.get(kname, {}),
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
            "eager_ms": rec["eager_ms"],
            "launches_by_variant": BY_VARIANT.get(name, {}),
            "per": per,
        })
    return out


ONLY = {  # an argument that stops after some kernels' checks and times (no result line)
    "--mma-only": ("mma",),
    "--flash-only": ("flash",),
    "--hamming-only": ("hamming",),
    "--fused-only": ("fused",),
    "--kernels-only": ("fused", "hamming", "flash", "mma"),
}


TELEMETRY_ONLY = "--telemetry-only"  # the telemetry phase alone (no result line)
SIMULATORS_ONLY = "--simulators-only"  # the simulators phase alone (no result line)
ALONE = {TELEMETRY_ONLY: "telemetry", SIMULATORS_ONLY: "simulators"}


def main(argv: list[str]) -> int:
    if argv and (len(argv) > 1 or argv[0] not in (*ONLY, *ALONE)):
        print(f"usage: chip_smoke.py [{' | '.join((*ONLY, *ALONE))}]", file=sys.stderr)
        return 2
    phase("device")
    card = check_device()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    phase("build")
    build_kernels()
    if argv and argv[0] in ALONE:
        phase(ALONE[argv[0]])
        (telemetry_phase if argv[0] == TELEMETRY_ONLY else simulators_phase)()
        print(card, flush=True)
        return 0
    phase("kernels")
    if argv:  # some kernels alone; no result line
        only = ONLY[argv[0]]
        ham = tuple(k for k, o in (("fused_bnn_matmul", "fused"), ("hamming_matmul", "hamming"))
                    if o in only)
        if ham:
            check_kernels(ham)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        if "flash" in only:
            check_flash(gen)
        if "mma" in only:
            check_mma(gen)
        print(card, flush=True)
        return 0
    checked = check_kernels()
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
    phase("simulators")
    simulators_phase()
    phase("telemetry")
    telemetry_phase()
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
    raise SystemExit(main(sys.argv[1:]))
