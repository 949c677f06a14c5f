#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--mma-only | --flash-only | --hamming-only | --fused-only |
                           --kernels-only | --telemetry-only | --simulators-only |
                           --faults-only | --train-only | --train-breadth-only |
                           --breadth-only | --frontends-only | --distributed-only |
                           --dryrun-only | --decode-graph-only]

Each ``--*-only`` argument stops after those kernels' checks and timings
(``--kernels-only``: every kernel's; ``--telemetry-only``,
``--simulators-only``, ``--faults-only``, ``--train-only``,
``--train-breadth-only``, ``--breadth-only``, ``--frontends-only``,
``--distributed-only``, ``--dryrun-only`` and ``--decode-graph-only``:
the build and that phase
alone) and prints no
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
   fp32, the Hamming kernel also at seamless-m4t-large-v2's encoder FFN
   shape (4096 rows, 1024 -> 8192), and -- with the ragged and
   block-padded shapes (``popc``), the
   Hamming kernel's words packed from them and bitlinear's ragged
   (``wmma``) and k-edge (``sm90``) shapes in bf16 and fp32 -- on signed
   zeros, NaN, subnormals of both signs and -2^-126, which must
   binarize as ``x > -2^-126`` (the JAX reference's ``x >= 0`` with
   subnormals read as zero), flash attention on
   prefill, continuation, ragged, D = 128, non-causal and the frontends
   phase's encoder, cross-attention and GQA-7 prefill cases in bf16
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
   medians and the traced and untraced tok/s;
9. faults: the same model under fault injection and tolerance -- a null
   ``FaultModel`` on ``packed`` == plain packed on the fused kernel;
   stuck cells on ``packed`` == ``tacitmap`` under the same model, every
   projection through the Hamming kernel; a tile failing mid-serve on
   ``tiled`` remapped by the health monitor, every generation == alone;
   then the paper's MLP and LeNet on 10 000 images, every engine ==
   ``reference``, and the multi-level sweep's gates; a ``{"faults":
   ...}`` JSON line;
10. train: tinyllama-1.1b at full width trained 12 steps with ``quant=
   "bnn"`` through ``repro_torch.train.train`` (one async checkpoint, the
   loss falls), served from the trained weights on ``packed`` (110 fused
   ``b1`` launches per tick) == ``reference``; at 4 of its layers a clean
   run resumed bit for bit after an injected fault and after a SIGTERM;
   then the paper MLP trained 300 steps and read out on four engines; a
   ``{"train": ...}`` JSON line. The fused launches of its serve join row
   1's count. The script sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before
   CUDA starts, for the deterministic cuBLAS the bitwise resume needs;
11. train breadth: internvl2-1b (24 layers, 256 patches), seamless-m4t-
   large-v2 (24 + 24 layers, 512 frames), mamba2-2.7b (8 of 64 layers)
   and qwen3-moe-235b-a22b (1 of 94 layers, factored AdamW) trained at
   full width, 4 steps of 8 x 128 tokens each (the loss falls), a second
   run equal on every parameter and optimizer-state tensor, and the
   trained weights served on ``packed`` == ``reference`` (fused ``b1``
   for internvl2 and qwen3-moe, Hamming ``b1`` for seamless); a
   ``{"train_breadth": ...}`` JSON line. Its launches join rows 1 and 2;
12. breadth: the MoE, Mamba-2 and hybrid decoder stacks -- (a)
   qwen3-moe-235b-a22b at full width, depth cut to 2 layers, on both
   attention paths, (b) mamba2-2.7b at full width, depth cut to 8 of
   its 64 layers, (c) jamba-1.5-large-398b's smoke config (a full-width
   repeat outgrows the
   card): lockstep packed == reference bit for bit, 8 slots == each
   request alone, evict/restore unchanged, with prefill ms, decode tok/s,
   launches per tick, a profiled tick and peak memory; (a)'s attention
   through the flash kernel == the plain ops' at its shape within
   ``ATTN_TOL``; mamba2 launches
   no kernel; jamba refuses ``prefill_continue`` and serves a 2-replica
   fleet with no graft; a ``{"breadth": ...}`` JSON line. (a)'s fused
   ``b1`` and flash ``sm90`` launches join rows 1 and 3;
13. frontends: (a) seamless-m4t-large-v2 at full width and depth (24 +
   24 layers, 512 source frames) served as the serve CLI serves it, every
   projection through the Hamming kernel (432 ``b1`` launches per
   prefill, 216 per tick) on both attention paths, packed == reference
   bit for bit, decode == prefill at one position within a stated bound
   that three planted decode faults exceed, the encoder's, the
   cross-attention's and the decoder self-attention's flash == plain ops
   within ``ATTN_TOL``; (b) internvl2-1b at full width and depth, 256 patch
   embeddings before each 128-token prompt, on both paths (120 fused
   ``b1`` per prefill or tick, 24 flash ``sm90`` per prefill), packed ==
   reference, the request path with token prompts == alone; a
   ``{"frontends": ...}`` JSON line. Its Hamming, fused and flash
   launches join rows 2, 1 and 3;
14. decode graph: ``CompiledModel.decode_step`` replayed as a CUDA graph
   (``compiler/decode_graph.py``) against eager steps on ``packed`` --
   internvl2-1b's lockstep wave of 32 images over 64 steps,
   qwen3-moe-235b-a22b at 1 of 94 layers in 64 slots and tinyllama-1.1b
   in 8 through ``serve()``, mamba2-2.7b at 8 of 64 layers and the
   hybrid's smoke config in lockstep: the logits and every cache tensor
   ``torch.equal`` at every step, the tokens equal; ms per step both ways
   by CUDA events and the graphed side's ``model_decode_graph_total``;
15. distributed: ``repro_torch.distributed`` on ``torch.distributed``
   -- (a) a one-rank NCCL group on the card: every collective and the
   compressed all-reduce give their n = 1 identities; (b) two spawned
   ranks sharing the card on gloo probe which collectives gloo runs on
   CUDA tensors (the rest go through pinned host memory); in that
   world (c) expert-parallel MoE at qwen3-moe-235b-a22b's full width,
   one layer, 64 experts per rank: a prefill under the mesh context, the
   EP layer == ``moe_ffn`` within the reference test's 3e-2 at
   drop-free capacity and a planted fault beyond it, the drop share at
   capacity 1.25; (d) GPipe of tinyllama-1.1b's 22 programmed layers in
   2 stages, 4 microbatches, == the single-process run bit for bit; (e)
   the int8 error-feedback all-reduce of tinyllama-1.1b's 1.1 B-entry
   gradient tree, bit for bit against the reference's arithmetic; a
   ``{"distributed": ...}`` JSON line. The ranks' fused launches ((c)
   and (d)) join row 1;
16. dryrun: the dry-run's step analysis (``launch/hlo_analysis.py``,
   ``steps.trace_cell``) against the card -- tinyllama-1.1b at full width,
   the train phase's step (8 x 128 tokens, plain-ops attention, remat,
   one rank, fp32 parameters): (b) its product FLOPs equal
   ``torch.profiler(with_flops=True)``'s over mm / addmm / bmm / baddbmm
   for one real step on the card; (c) its predicted peak is within
   ``DRYRUN_PEAK_TOL`` of ``torch.cuda.max_memory_allocated()`` over that
   step; (d) its three roofline seconds printed beside the measured
   median step and device-busy ms; (e) the EP layer at
   qwen3-moe-235b-a22b's full width on two ranks: the traced all-to-all
   bytes per rank equal what a real gloo run moved; (f) the production
   cell tinyllama-1.1b ``train_4k`` on (16, 16) traced on the card's host,
   its record and ``trace_s`` printed (a failed trace is printed as the
   reference's ``status: "error"`` record, then fails the phase); (a) the
   same cell traced meanwhile in a child process that sees no card
   (``CUDA_VISIBLE_DEVICES=''``) gives (f)'s record field for field: the
   record does not depend on the tracing host; a ``{"dryrun": ...}``
   JSON line. No kernel runs in it.

Then the whole run's seconds, one ``{"kernels": [...]}`` JSON line, the
card line again, and last ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
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


# Hamming-only cases (label, rows, m, n): seamless-m4t-large-v2's encoder
# FFN w1/w3 over a prefill of 8 x 512 frames (the frontends phase runs
# every projection of that model through the Hamming kernel)
HAMMING_ONLY = (("seamless-enc-w1/w3 B=4096", 4096, 1024, 8192),)


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
    cases = [(*c, which) for c in cases]
    if "hamming_matmul" in which:
        cases += [(label, b, m, n, False, ("hamming_matmul",)) for label, b, m, n in HAMMING_ONLY]
    rec = {k: {} for k in which}
    worst = dict.fromkeys(which, 0.0)
    if "fused_bnn_matmul" in which:
        worst["fused_bnn_matmul"] = check_fused_edges(gen)
    for label, b, m, n, prepad, kernels in cases:
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
        if "fused_bnn_matmul" in kernels:
            # the projection shapes take b1; the ragged and block-padded
            # ones (bf16 rows of 200 or 600 bytes) popc
            fplan, err = _check_fused(label, x, wp, alpha, beta, m, n,
                                      "popc" if m in (100, 300) else "b1")
            worst["fused_bnn_matmul"] = max(worst["fused_bnn_matmul"], err)
            plan_text = f"; fused {fplan.describe()}"
        dot = bnn.nonneg(x).float() * 2 - 1
        if "hamming_matmul" in kernels:
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
        print(f"[kernels] {label}: {' and '.join(kernels)} == plain"
              f"{' == ±1 matmul, two launches equal' if 'hamming_matmul' in kernels else ''}"
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
        for kname in kernels:
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
    # the breadth phase's qwen3-moe-235b-a22b prefill: 64 heads, GQA groups of 16
    ("qwen3-moe prefill", 8, 64, 4, 128, 128, 64, True),
    ("non-causal square", 1, 32, 4, 128, 128, 64, False),
    # fewer queries than a tile over a ragged key length: the masked edge
    # tile without a diagonal
    ("non-causal 40 over 100", 2, 8, 2, 40, 100, 64, False),
    # the frontends phase's shapes: seamless-m4t-large-v2's encoder (512
    # frames), cross-attention (128 decoder queries over 512 frames) and
    # decoder self-attention (GQA group 1, causal), internvl2-1b's prefill
    # (256 patches + 128 tokens, GQA groups of 7)
    ("seamless encoder", 8, 16, 16, 512, 512, 64, False),
    ("seamless cross", 8, 16, 16, 128, 512, 64, False),
    ("seamless decoder self", 8, 16, 16, 128, 128, 64, True),
    ("internvl2 prefill", 8, 14, 2, 384, 384, 64, True),
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


def _hamming_variants() -> dict[str, int]:
    from repro_torch.kernels import xnor_matmul

    return dict(xnor_matmul.launches_by_variant)


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


def profile_decode(compiled, tokens, tick_ms: float, extra_embeds=None) -> dict | None:
    """Where a decode tick's time goes: PROFILE_TICKS lockstep ticks under
    ``torch.profiler`` after an unprofiled prefill (after ``extra_embeds``,
    a VLM's patches, when given). Prints the host wall time per tick, the
    device time the profiler attributes to kernels and copies, their
    share of that wall time and of ``tick_ms`` (the same tick measured
    without the profiler), the device launches per tick and the kernels
    that take the most device time, and the device time of the kernels
    launched inside ``dense``'s latent-weight span; returns those per
    tick. A profiler that reports no device time prints "not measured"
    and returns None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.device import synchronize
    from repro_torch.models.layers import LATENT_WEIGHT_SPAN

    dev = compiled.device
    start = tokens.shape[1] + (0 if extra_embeds is None else extra_embeds.shape[1])
    logits, pre = compiled.prefill(tokens, extra_embeds)
    caches = compiled.graft_prefill_caches(
        compiled.init_cache(tokens.shape[0], start + PROFILE_TICKS), pre
    )
    tok = torch.argmax(logits, dim=-1)
    synchronize(dev)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_TICKS):
            logits, caches = compiled.decode_step(tok, start + i, caches)
            tok = torch.argmax(logits, dim=-1)
        synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_TICKS
    # device-side events only (kernels, copies): the host ops that launch
    # them carry the same device time again, and a program range's
    # device-side annotation covers its kernels again
    averages = prof.key_averages()
    rows = [
        (getattr(e, "self_device_time_total", 0) / 1e3 / PROFILE_TICKS, e.count / PROFILE_TICKS, e.key)
        for e in averages
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        and e.key not in obs.RANGES
    ]
    # the kernels launched inside dense's latent-weight span (host side)
    weight_ms = sum(getattr(e, "device_time_total", 0) for e in averages
                    if e.key == LATENT_WEIGHT_SPAN and e.device_type == DeviceType.CPU
                    ) / 1e3 / PROFILE_TICKS
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    device_ms = sum(r[0] for r in rows)
    if not rows:
        print(f"[profile] decode tick {wall_ms:.2f} ms wall under the profiler; device "
              f"time not measured (the profiler reported none)", flush=True)
        return None
    print(f"[profile] decode tick {wall_ms:.2f} ms wall under the profiler, device busy "
          f"{device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f}%, idle "
          f"{100 - 100 * device_ms / wall_ms:.1f}%); {100 * device_ms / tick_ms:.1f}% of the "
          f"{tick_ms:.2f} ms unprofiled tick; {sum(r[1] for r in rows):.0f} device launches "
          f"per tick", flush=True)
    for ms, count, name in rows[:8]:
        print(f"[profile]   {ms:.4f} ms/tick in {count:.0f} launches: {name[:90]}", flush=True)
    if weight_ms:
        print(f"[profile]   of which the latent weight side ({LATENT_WEIGHT_SPAN}: alpha, "
              f"binarize and pack on a weight-cache miss) {weight_ms:.4f} ms/tick, "
              f"{100 * weight_ms / device_ms:.1f}% of device busy", flush=True)
    return {"wall_ms": wall_ms, "device_ms": device_ms, "launches": sum(r[1] for r in rows),
            "weight_side_ms": weight_ms}


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

    from repro_torch.kernels import rows
    from repro_torch.models import layers

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    x = torch.randn((64, 2048), generator=gen, device=device)
    w = torch.randn((2048, 4096), generator=gen, device=device)
    q = torch.randn((8, 1, 32, 64), generator=gen, device=device).to(torch.bfloat16)
    kc, vc = (torch.randn((8, 160, 4, 64), generator=gen, device=device).to(torch.bfloat16)
              for _ in range(2))
    lens = torch.full((8,), 101, device=device)
    counts = (1, 2, 8, 15)

    def same(f, full, n):
        """Largest |difference| of the first r rows, computed alone,
        from the same rows inside the full call (0.0: equal bits)."""
        return max((f(r).float() - full[:r].float()).abs().max().item() for r in n)

    lib = {
        "mean": same(lambda r: (x[:r] * x[:r]).mean(-1), (x * x).mean(-1), counts),
        "fp32 matmul": same(lambda r: x[:r] @ w, x @ w, counts),
        "decode attention in one call": same(
            lambda r: layers._decode_block(q[:r], kc[:r], vc[:r], lens[:r]),
            layers._decode_block(q, kc, vc, lens), (1, 2, 4)),
    }
    port = {
        "rows.row_mean": same(lambda r: rows.row_mean(x[:r] * x[:r]), rows.row_mean(x * x),
                              counts),
        "rows.matmul": same(lambda r: rows.matmul(x[:r], w), rows.matmul(x, w), counts),
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
# port pads it (rows.row_mean): the graft must stay exact there too
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


def _attention_impls_agree(cfg, device: str, what: str, sq: int = PROMPT, skv: int = PROMPT,
                           causal: bool = True, chunk: int | None = None) -> float:
    """One layer's attention at ``cfg``'s heads over BATCH x ``sq``
    queries and ``skv`` keys (default: the lockstep prefill, causal) on
    seeded bf16 q/k/v, through ``multi_head_attention`` (the function the
    model calls) with ``impl="pallas"`` (the flash kernel) and ``"jnp"``
    (plain ops, key chunks of ``chunk``, default ``cfg.attn_chunk``): the
    max |diff|, which must be within ATTN_TOL."""
    import torch

    from repro_torch.models import layers as layers_lib

    attn = [torch.randn((BATCH, s, n, cfg.hd), generator=torch.Generator(device=device)
                        .manual_seed(SEED + i), device=device).to(torch.bfloat16)
            for i, (s, n) in enumerate(((sq, cfg.n_heads), (skv, cfg.n_kv_heads),
                                        (skv, cfg.n_kv_heads)))]
    q_pos = torch.arange(skv - sq if causal else 0, skv if causal else sq, device=device)
    kv_pos = torch.arange(skv, device=device)
    by_impl = [layers_lib.multi_head_attention(*attn, q_pos, kv_pos, causal=causal,
                                               chunk=chunk or cfg.attn_chunk, impl=impl)
               for impl in ("jnp", "pallas")]
    ok, diff = _within(by_impl[1], by_impl[0], ATTN_TOL, ATTN_TOL)
    if not ok:
        raise AssertionError(f"{what}: one layer's attention, pallas vs jnp: max |diff| {diff} "
                             f"beyond {ATTN_TOL}")
    return diff


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
    the flash kernel launched once per layer per prefill or continuation
    (grafts == alone holds on dense-FFN stacks only: an MoE continuation
    follows the reference's, whose expert capacity depends on the
    sequence length); (d) the single engine of 8 slots equals each
    request alone, for both attention paths. Returns the flash launches
    of the fleet run."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import compiler
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import synchronize
    from repro_torch.launch import serve
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
    attn_diff = _attention_impls_agree(cfg, device, "pallas")
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

    from repro_torch import obs
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
    # kernels and copies, not the program ranges' device-side annotations
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and e.key not in obs.RANGES]
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


def _inside(inner, outer) -> bool:
    return any(s <= inner[0] and inner[1] <= e for s, e, _ in outer)


def _profiled_request_path(argv: list[str], device: str, want: dict) -> dict:
    """The serve CLI's request path (``argv``, telemetry on) under
    ``torch.profiler``: the tokens of the untraced run; the program
    ranges on the profiler's clock, one ``model.decode_step`` per tick
    inside its ``decode_tick`` span's range inside a ``scheduler.step``,
    one ``model.prefill`` per prefill inside its ``prefill``, ``lm.head``
    once in each but a decode step replayed as a CUDA graph (which runs
    no Python inside). Returns the decode steps' median host time and their
    kernels' device time per step (0 on the CPU)."""
    import statistics

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.compiler import decode_graph
    from repro_torch.launch import serve

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=activities) as prof:
        run = serve.run(argv)
    tokens = {s.rid: tuple(s.generated) for s in run["states"]}
    if tokens != want:
        bad = sorted(r for r in tokens if tokens[r] != want.get(r))
        raise AssertionError(f"request path: tokens under the profiler differ for {bad}")
    ranges: dict[str, list] = {name: [] for name in obs.RANGES}
    for e in prof.events():
        if e.name in obs.RANGES and e.device_type == DeviceType.CPU:
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end, getattr(e, "device_time_total", 0)))
    st = run["stats"]
    n = {name: len(v) for name, v in ranges.items() if v}
    replayed = int(run["telemetry"].metrics.counter(decode_graph.COUNTER).labels(
        outcome="replay").value)
    want_n = {"model.decode_step": st.ticks, "decode_tick": st.ticks, "prefill": st.prefills,
              "model.prefill": st.prefills, "lm.head": st.ticks - replayed + st.prefills}
    nested = (all(_inside(r, ranges["scheduler.step"]) for r in ranges["decode_tick"])
              and all(_inside(r, ranges["decode_tick"]) for r in ranges["model.decode_step"])
              and all(_inside(r, ranges["prefill"]) for r in ranges["model.prefill"]))
    if any(n.get(k) != v for k, v in want_n.items()) or n.get("scheduler.step", 0) < st.ticks \
            or not nested:
        raise AssertionError(f"request path under the profiler: ranges {n} (nested {nested}), "
                             f"want {want_n}")
    steps = ranges["model.decode_step"]
    host_ms = statistics.median(e - s for s, e, _ in steps) / 1e3
    device_ms = sum(d for _, _, d in steps) / 1e3 / len(steps)
    print(f"[telemetry] request path under torch.profiler: tokens == untraced; ranges {n}, "
          f"model.decode_step inside decode_tick inside scheduler.step, {replayed} of its "
          f"{st.ticks} ticks replayed as a CUDA graph; a decode step "
          f"{host_ms:.2f} ms host (median), {device_ms:.3f} ms device", flush=True)
    return {"model.decode_step host ms": host_ms, "model.decode_step device ms": device_ms}


def telemetry_phase(device: str = "cuda", smoke: bool = False, out: Path = TELEMETRY_OUT) -> dict:
    """The port's own telemetry on the two request traces, each run once
    more with a session on: (a) the request path through the serve CLI's
    ``--trace-out`` / ``--metrics-out`` (16 requests, jnp attention, 8
    slots); (b) the 2-replica prefix-routed fleet (``attn_impl="pallas"``)
    inside ``obs.session()``; then (a) once more under ``torch.profiler``,
    with the program ranges checked (``_profiled_request_path``). Each
    traced run must give the tokens of
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
    req.update(_profiled_request_path(req_args + ["--metrics-out", str(out / "requests" /
                                                                      "profiled_metrics.txt")],
                                      device, UNTRACED["requests"]["tokens"]))

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


# ---------------------------------------------------------------------------
# phase 9: faults
# ---------------------------------------------------------------------------

# phase (b)'s fault model: 1e-3 of the cells stuck, half SET, half RESET
FAULT_RATES = {"seed": 0, "stuck_set_rate": 5e-4, "stuck_reset_rate": 5e-4}
# phase (c): 8 requests (prompts PROMPT/2..PROMPT) of FAULT_GEN tokens in
# BATCH slots, a resident tile failing before tick FAIL_TICK
FAULT_REQUESTS, FAULT_GEN, FAIL_TICK, SPARES = 8, 16, 2, 3
# phase (d): MNIST-test-set-sized batches of seeded random 28x28 images
N_IMAGES = 10_000
PAPER_ENGINES = ("packed", "tacitmap", "wdm", "custbinarymap")
SWEEPS = 3  # scan_faults calls timed after the serve


def _lockstep_logits(compiled, tokens, gen: int) -> dict:
    """The lockstep batch of ``serve.lockstep``, keeping every step's
    logits on the device: prefill, then ``gen - 1`` decode ticks."""
    import torch

    from repro_torch.device import synchronize

    b, s = tokens.shape
    logits, pre = compiled.prefill(tokens)
    caches = compiled.graft_prefill_caches(compiled.init_cache(b, s + gen), pre)
    steps = [logits]
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    synchronize(compiled.device)
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = compiled.decode_step(tok, s + i, caches)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
        steps.append(logits)
    synchronize(compiled.device)
    decode_s = time.perf_counter() - t0
    return {"generated": torch.stack(out, dim=1).cpu().numpy(), "logits": steps,
            "decode_tok_s": (gen - 1) * b / max(decode_s, 1e-9)}


def _same_steps(got: dict, want: dict) -> bool:
    import numpy as np
    import torch

    return np.array_equal(got["generated"], want["generated"]) and all(
        torch.equal(g, w) for g, w in zip(got["logits"], want["logits"], strict=True))


def _peak_gib(on_card: bool):
    import torch

    return torch.cuda.max_memory_allocated() / 2**30 if on_card else None


def _fresh_peak(on_card: bool) -> None:
    """Free what earlier work left (tensors held only by reference cycles,
    such as a serving engine and its health monitor, wait for the cyclic
    collector) and start a new peak."""
    import gc

    import torch

    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def faults_phase(device: str = "cuda", smoke: bool = False) -> dict:
    """Fault injection and tolerance at tinyllama-1.1b full width and
    depth (jnp attention, seeded weights), then the paper-level BNN and
    the multi-level cells:

    (a) null injection: ``packed`` wrapped in a ``FaultyEngine`` with a
        null ``FaultModel`` gives plain packed's prefill logits, every
        tick's logits and tokens bit for bit, on the fused kernel (110
        ``b1`` launches per tick);
    (b) live injection: ``FaultModel(seed=0, set=5e-4, reset=5e-4)`` on
        ``packed`` changes the logits, equals ``tacitmap`` under the same
        model bit for bit (both ePCM 256x256 tiles; integer sums), and
        runs every projection through the Hamming kernel (154 launches
        per tick, 0 fused); the executed consistency probe equals the
        cheap one on a w1 artifact; peak device memory printed (the
        deltas alone are 22 x 2 x 44.04M x 4 B = 7.75 GB);
    (c) a mid-serve tile failure: ``tiled`` (tacitmap policy, 3 spare
        tiles, null model) serving 8 requests in 8 slots; before tick 2 a
        resident tile fails (``fail_tile``, ``refresh_faults``,
        ``_rebind``); the health monitor detects, remaps once onto a
        spare and restarts the in-flight requests; every generation equals
        that request served alone on ``packed`` (tiled == packed at this
        width, as the simulators phase shows); sweep and remap times
        printed;
    (d) the paper's MLP 784-500-250-10 and LeNet on 10 000 seeded 28x28
        images: ``packed``, ``tacitmap``, ``wdm`` and ``custbinarymap``
        bit-equal to ``reference``; the Hamming kernel's variant per
        binary-layer shape printed;
    (e) the multi-level sweep at the reference's defaults: exact at
        sigma 0 but for the ADC's rounding, binary cells exact at sigma
        <= 0.02, 4-bit cells above 5% error at sigma >= 0.05, and the
        error rising with depth at sigma = 0.05 (the gates of the JAX
        package's ``benchmarks/multilevel.py``).

    ``device="cpu", smoke=True`` rehearses it at the smoke config's size
    (launch counts are then not read). Returns the phase's numbers."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import compiler, obs
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import model as paper
    from repro_torch.core import multilevel
    from repro_torch.device import synchronize
    from repro_torch.faults import FaultModel
    from repro_torch.kernels import ops, xnor_matmul
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import Request

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    cfg = dataclasses.replace(get_smoke_config(ARCH) if smoke else get_config(ARCH), quant="bnn")
    layers = cfg.n_layers
    tokens = serve.prompts(cfg, BATCH, PROMPT, SEED)
    out: dict = {}

    def compiled(target):
        params = lm.init_params(torch.Generator(device=device).manual_seed(SEED), cfg,
                                device=device)
        return compiler.compile(cfg, params, target, device=device)

    def ham_variants() -> dict:
        return dict(xnor_matmul.launches_by_variant)

    # (a) null injection == plain packed, on the fused kernel
    _fresh_peak(on_card)
    plain = _lockstep_logits(compiled(compiler.HardwareTarget(engine="packed")), tokens, GEN)
    model = compiled(compiler.HardwareTarget(engine="packed", fault_model=FaultModel()))
    _reset_counts()
    null = _lockstep_logits(model, tokens, GEN)
    _check_launches(device, {**_counts(), "fused by variant": _fused_variants()},
                    {"fused_bnn_matmul": layers * 5 * GEN, "hamming_matmul": 0,
                     "fused by variant": {"popc": 0, "b1": layers * 5 * GEN}}, "null injection")
    if not _same_steps(null, plain):
        raise AssertionError("null fault model: logits or tokens differ from plain packed")
    out["null"] = {"decode_tok_s": null["decode_tok_s"], "plain_tok_s": plain["decode_tok_s"]}
    print(f"[faults] (a) null FaultModel on packed: prefill and {GEN - 1} ticks' logits and "
          f"tokens == plain packed bit for bit; fused {layers * 5} launches per tick, all b1; "
          f"{null['decode_tok_s']:.1f} tok/s (plain {plain['decode_tok_s']:.1f})", flush=True)
    del model, null

    # (b) live injection: packed == tacitmap under the same fault model
    fm = FaultModel(**FAULT_RATES)
    _fresh_peak(on_card)
    model = compiled(compiler.HardwareTarget(engine="packed", fault_model=fm))
    program_ms = model.program_s * 1e3
    _reset_counts()
    faulty = _lockstep_logits(model, tokens, GEN)
    launched = {**_counts(), "hamming by variant": ham_variants()}
    _check_launches(device, launched,
                    {"fused_bnn_matmul": 0, "hamming_matmul": layers * 7 * GEN,
                     "hamming by variant": {"popc": 0, "b1": layers * 7 * GEN}},
                    "faulty packed lockstep")
    if torch.equal(faulty["logits"][0], plain["logits"][0]):
        raise AssertionError("stuck cells left the prefill logits unchanged")
    w1 = model.params.blocks[0].ffn.w1.prepared
    cheap = model.engine.consistency_probe(w1)
    executed = model.engine.consistency_probe(w1, execute=True)
    if not np.array_equal(cheap, executed) or cheap.max() == 0:
        raise AssertionError(f"w1 probe: cheap max {cheap.max()} vs executed {executed.max()}")
    delta_gb = sum(p.delta.numel() * 4 for _, p in lm.programmed_projections(model.params)) / 1e9
    packed_peak = _peak_gib(on_card)
    del model
    _fresh_peak(on_card)
    model = compiled(compiler.HardwareTarget(engine="tacitmap", fault_model=fm))
    tacit = _lockstep_logits(model, tokens, GEN)
    tacit_peak = _peak_gib(on_card)
    del model
    if not _same_steps(faulty, tacit):
        raise AssertionError("faulty packed != faulty tacitmap (logits or tokens)")
    flipped = int((faulty["generated"] != plain["generated"]).sum())
    out["live"] = {"decode_tok_s": faulty["decode_tok_s"], "tacitmap_tok_s": tacit["decode_tok_s"],
                   "program_ms": program_ms, "delta_gb": delta_gb,
                   "peak_gib": packed_peak, "tacitmap_peak_gib": tacit_peak,
                   "hamming_by_variant": launched["hamming by variant"],
                   "tokens_changed": flipped, "probe_max": float(cheap.max())}
    mem = (f"peak {packed_peak:.2f} GiB (tacitmap {tacit_peak:.2f})" if on_card
           else "peak memory not measured (CPU)")
    print(f"[faults] (b) {fm.describe().removeprefix('[faults] ')} on packed: prefill logits changed, {flipped} of "
          f"{faulty['generated'].size} tokens differ from fault-free; == tacitmap under the same "
          f"model, every step's logits and tokens bit for bit; Hamming {layers * 7} launches per "
          f"tick by variant {launched['hamming by variant']}, fused 0; w1 probe executed == cheap "
          f"(max {cheap.max():.0f}); deltas {delta_gb:.2f} GB, programmed in {program_ms:.1f} ms, "
          f"{mem}; decode {faulty['decode_tok_s']:.1f} tok/s (plain packed "
          f"{plain['decode_tok_s']:.1f}, faulty tacitmap {tacit['decode_tok_s']:.1f})", flush=True)
    del faulty, tacit, plain
    _release({})

    # (c) a tile fails mid-serve; the health monitor remaps it away
    rng = np.random.default_rng(REQUEST_SEED)
    trace = serve.prompts(cfg, FAULT_REQUESTS, PROMPT, SEED)
    reqs = [Request(rid=i, prompt=trace[i, : int(rng.integers(PROMPT // 2, PROMPT + 1))]
                    .astype(np.int32), max_new_tokens=FAULT_GEN) for i in range(FAULT_REQUESTS)]
    max_len = PROMPT + FAULT_GEN
    _fresh_peak(on_card)
    model = compiled(compiler.HardwareTarget(engine="tiled", mapping_policy="tacitmap",
                                             spare_tiles=SPARES, fault_model=FaultModel()))
    victim = min(t for pw in model._fault_artifacts()
                 for *_, t in model.engine._placement_blocks(pw.m, pw.n))
    with obs.session() as tel:
        se = model.serve(max_batch=BATCH, max_len=max_len)
        states = [se.submit(r) for r in reqs]
        t0 = time.perf_counter()
        ticks = 0
        while not se.idle():
            if ticks == FAIL_TICK:
                model.engine.fail_tile(victim)
                model.refresh_faults()
                se._rebind()
            se.step()
            ticks += 1
        synchronize(model.device)
        wall_s = time.perf_counter() - t0
    h = se.health
    restarted = se.stats().scheduler.restarted
    if h.remaps != 1 or h.degraded or victim not in h.quarantined or restarted < 1:
        raise AssertionError(f"health: remaps={h.remaps} degraded={h.degraded} quarantined="
                             f"{sorted(h.quarantined)} (victim {victim}) restarted={restarted}")
    remap_ms = [s.duration_s * 1e3 for s in tel.tracer.spans("remap")]
    events = [(r.name, r.attrs) for r in tel.tracer.records if r.name.startswith("fault.")]
    sweep_ms = []
    for _ in range(SWEEPS):
        synchronize(model.device)
        t0 = time.perf_counter()
        clean = model.scan_faults()
        sweep_ms.append((time.perf_counter() - t0) * 1e3)
    if clean.tiles:
        raise AssertionError(f"the sweep after the remap still flags tiles {sorted(clean.tiles)}")
    tiled_peak = _peak_gib(on_card)
    del model, se
    _release({})
    alone_model = compiled(compiler.HardwareTarget(engine="packed"))
    for r, st in zip(reqs, states):
        one = alone_model.serve(max_batch=1, max_len=max_len)
        alone = one.submit(r)
        one.drain()
        if len(st.generated) != FAULT_GEN or tuple(alone.generated) != tuple(st.generated):
            raise AssertionError(f"request {r.rid} through the tile failure != alone on packed")
    del alone_model
    toks = sum(len(st.generated) for st in states)
    out["tolerance"] = {"victim": victim, "ticks": ticks, "restarted": restarted,
                        "remap_ms": remap_ms, "sweep_ms": statistics.median(sweep_ms),
                        "events": events,
                        "wall_s": wall_s, "tok_s": toks / wall_s, "peak_gib": tiled_peak}
    mem = f"peak {tiled_peak:.2f} GiB" if on_card else "peak memory not measured (CPU)"
    print(f"[faults] (c) tiled (tacitmap plan, {SPARES} spares): tile {victim} failed before tick "
          f"{FAIL_TICK}; remaps={h.remaps}, quarantined={sorted(h.quarantined)}, degraded="
          f"{h.degraded}, restarted={restarted}; {FAULT_REQUESTS} requests in {BATCH} slots "
          f"== each alone on packed, {ticks} ticks in {wall_s * 1e3:.1f} ms ({toks / wall_s:.1f} "
          f"tok/s); remap span {', '.join(f'{x:.1f}' for x in remap_ms)} ms; scan_faults "
          f"{statistics.median(sweep_ms):.2f} ms per sweep (median of {SWEEPS}); {mem}; "
          f"events {events}", flush=True)

    # (d) the paper's MLP and LeNet on every engine == reference
    gen = torch.Generator(device=device).manual_seed(SEED)
    n_img = 64 if smoke else N_IMAGES
    mlp_cfg, conv_cfg = paper.MLPConfig(), paper.ConvConfig()
    mlp = paper.init_mlp(gen, mlp_cfg, device=device)
    conv = paper.init_conv(gen, conv_cfg, device=device)
    x_mlp = torch.randn((n_img, mlp_cfg.dims[0]), generator=gen, device=device)
    x_img = torch.randn((n_img, conv_cfg.in_hw, conv_cfg.in_hw, conv_cfg.in_ch), generator=gen,
                        device=device)
    runs = {
        "mlp": lambda e: paper.mlp_forward_infer(mlp, x_mlp, mlp_cfg, e),
        "lenet": lambda e: paper.conv_forward(conv, x_img, conv_cfg, train=False, engine=e),
    }
    paper_out = {}
    for net, run in runs.items():
        want = run("reference")
        if want.shape != (n_img, 10) or not torch.isfinite(want).all():
            raise AssertionError(f"{net}: logits of shape {tuple(want.shape)} not finite")
        times, variants = {}, {}
        for engine in PAPER_ENGINES:
            _reset_counts()
            synchronize(torch.device(device))
            t0 = time.perf_counter()
            got = run(engine)
            synchronize(torch.device(device))
            times[engine] = (time.perf_counter() - t0) * 1e3
            if not torch.equal(got, want):
                raise AssertionError(f"{net} on {engine} != the reference engine")
            if engine == "packed":
                variants = ham_variants()
        paper_out[net] = {"ms": times, "hamming_by_variant": variants}
        print(f"[faults] (d) {net} on {n_img} images: {', '.join(PAPER_ENGINES)} == reference bit "
              f"for bit; packed's Hamming launches by variant {variants}; ms "
              f"{ {k: round(v, 2) for k, v in times.items()} }", flush=True)
    # each binary-layer shape of the two nets, alone: its Hamming variant
    shapes = {}
    for m, n, rows in ((500, 250, n_img), (150, 16, n_img * 64), (256, 120, n_img),
                       (120, 84, n_img)):
        a = torch.ones((rows, m), device=device)
        w = torch.ones((m, n), device=device)
        _reset_counts()
        ops.xnor_matmul(a, w)
        shapes[f"{rows}x{m}x{n}"] = {k: v for k, v in ham_variants().items() if v}
    paper_out["variant_by_shape"] = shapes
    out["paper"] = paper_out
    print(f"[faults] (d) Hamming variant per binary layer (rows x m x n): {shapes}", flush=True)
    del mlp, conv, x_mlp, x_img

    # (e) multi-level cells: the reference's sweep and gates, on this device
    points = multilevel.sweep(device=device)
    by = {(p.bits, p.sigma): p.error_rate for p in points}
    ok = {
        "binary exact at sigma <= 0.02": all(e == 0.0 for (b, s), e in by.items()
                                             if b == 1 and s <= 0.02),
        "4-bit above 5% at sigma >= 0.05": all(e > 0.05 for (b, s), e in by.items()
                                               if b == 4 and s >= 0.05),
        "error rises with depth at sigma = 0.05": by[(1, 0.05)] <= by[(2, 0.05)] <= by[(4, 0.05)],
    }
    g = torch.Generator(device=device).manual_seed(SEED)
    for bits in (1, 2, 4):
        levels = 2**bits - 1
        a = torch.randint(0, levels + 1, (64, 64), generator=g, device=device)
        w = torch.randint(0, levels + 1, (64, 32), generator=g, device=device)
        exact = multilevel.multilevel_vmm_exact(a, w)
        # the ADC's step, divided by as a 0-dim tensor as noisy_vmm does
        lsb = torch.tensor(max(64 * levels * levels / multilevel.OPCM_TILE.adc_levels, 1.0),
                           device=device)
        noiseless = multilevel.noisy_vmm(a, w, bits, 0.0, g)
        ok[f"{bits}-bit at sigma 0 == the ADC's rounding of the exact MAC"] = torch.equal(
            noiseless, torch.round(exact / lsb) * lsb)
    if not all(ok.values()):
        raise AssertionError(f"multi-level gates: {ok}")
    out["multilevel"] = {f"{b}b@{s}": e for (b, s), e in by.items()}
    print(f"[faults] (e) multi-level sweep: {out['multilevel']}; gates {list(ok)} hold",
          flush=True)

    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"faults": out}), flush=True)
    print(f"[faults] phase {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 10: train tinyllama-1.1b at full width, then serve what it learned
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_EVERY, TRAIN_LR, TRAIN_WARMUP = 12, 4, 3e-4, 2
TRAIN_FAULT_STEP, TRAIN_PREEMPT_STEP = 6, 5
# (b)'s depth: 4 of tinyllama's 22 layers at full width, so that its
# checkpoints are ~3.7 GB, not 13.2 GB
RESUME_LAYERS = 4
TRAIN_TICKS = 16  # decode ticks served from the trained weights
MLP_STEPS, MLP_BATCH, MLP_LR, MLP_EVAL = 300, 128, 1e-3, 512
MLP_ENGINES = ("packed", "tacitmap", "wdm")  # each held to "reference"


def _train_state(out) -> list:
    """``(tree path, host copy)`` of a run's final parameters (the
    reference's stacked tree of its model family) and optimizer state."""
    from repro_torch import tree as tree_lib
    from repro_torch.models import encdec, lm

    model = out["params"]
    params = (encdec if isinstance(model, encdec.EncDec) else lm).param_tree(model, device="cpu")
    state = tree_lib.tree_map(lambda t: t.to("cpu", copy=True), out["opt_state"])
    return [(tree_lib.key(p), t) for p, t in tree_lib.leaves_with_paths((params, state))]


def _state_mismatches(out, want: dict) -> list[str]:
    """The leaves of a run's final state that are not ``torch.equal`` to
    ``want`` (host copies keyed by tree path)."""
    import torch

    got = _train_state(out)
    if [k for k, _ in got] != list(want):
        return ["<tree structure>"]
    return [k for k, t in got if not torch.equal(t, want[k])]


def _train_mlp(device: str, gen, steps: int) -> tuple[dict, float, list[float]]:
    """examples/train_bnn.py's run: the paper MLP trained with STE on the
    synthetic image stand-in, AdamW without decay. Returns the params,
    the wall seconds and the losses."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import model as paper
    from repro_torch.data import bnn_image_batch
    from repro_torch.device import synchronize
    from repro_torch.optim import OptConfig, adamw_init, adamw_update

    cfg = paper.MLPConfig()
    params = {k: v.requires_grad_(True) for k, v in paper.init_mlp(gen, cfg, device=device).items()}
    opt_cfg = OptConfig(weight_decay=0.0)
    opt = adamw_init(params, opt_cfg)
    losses = []
    synchronize(torch.device(device))
    t0 = time.perf_counter()
    for i in range(steps):
        x, y = bnn_image_batch(MLP_BATCH, shape=(28, 28, 1), step=i, device=device)
        logits = paper.mlp_forward_train(params, x.reshape(MLP_BATCH, -1), cfg)
        loss = -(F.one_hot(y, 10) * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g  # the last g is unused
                 for (k, p), g in zip(params.items(), grads)}
        adamw_update(grads, params, opt, MLP_LR, opt_cfg)
        losses.append(loss.detach())
    synchronize(torch.device(device))
    return params, time.perf_counter() - t0, [float(v) for v in losses]


def train_phase(device: str = "cuda", smoke: bool = False) -> dict:
    """Training on the card: tinyllama-1.1b at full width and depth,
    ``quant="bnn"``, jnp attention, per-block remat, seeded weights, batch
    8 x 128 tokens, peak lr 3e-4 after 2 warmup steps, ``OptConfig()``,
    through ``repro_torch.train.train``:

    (a) 12 steps and one async checkpoint, at the last (a checkpoint of
        the parameters and AdamW moments is 13.2 GB): every loss finite,
        the mean of the last 3 below the mean of the first 3; the median
        step ms, tokens/s, peak device GiB and the save's host-blocking
        ms;
    (b) resume == never-failed, at 4 of the 22 layers (full width): a
        clean 12-step run with an async checkpoint every 4, then the same
        run with a fault injected at step 6 (one restart from the step-3
        checkpoint; one restore's ms), then a SIGTERM at step 5
        (checkpoint and exit) and a resumed run; each final parameter and
        optimizer-state tensor ``torch.equal`` to the clean run's;
    (c) train -> serve: (a)'s model compiled to ``packed`` and to
        ``reference``, 8 seeded 128-token prompts served for 16 decode
        ticks: tokens and prefill logits equal, 110 fused ``b1`` launches
        per packed prefill or tick and none on reference; one more
        optimizer step on the trained model moves neither compiled
        model's prefill logits (compile() holds copies);
    (d) the paper MLP 784-500-250-10 trained 300 steps at batch 128
        (examples/train_bnn.py's setup) and read out on 512 held-out
        images on ``reference``, ``packed``, ``tacitmap`` and ``wdm``:
        logits equal, accuracy above 0.5.

    ``device="cpu", smoke=True`` rehearses it at the smoke config's size,
    training on 8 x 64 tokens and the MLP for 60 steps (launch counts and
    device memory are then not read). Returns the phase's numbers;
    ``fused_bnn_matmul`` is (c)'s packed launch count."""
    import dataclasses
    import os
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch

    from repro_torch import compiler
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import model as paper
    from repro_torch.data import bnn_image_batch, lm_batch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, make_train_step, train

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    cfg = dataclasses.replace(get_smoke_config(ARCH) if smoke else get_config(ARCH),
                              quant="bnn", attn_impl="jnp", remat=True)
    layers = cfg.n_layers
    batch, seq = (BATCH, 64) if smoke else (BATCH, PROMPT)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    loop = TrainLoopConfig(total_steps=TRAIN_STEPS, batch_size=batch, seq_len=seq,
                           peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                           checkpoint_every=TRAIN_STEPS, keep=1, seed=SEED,
                           checkpoint_dir=os.path.join(root, "a"))
    log = lambda line: print(line, flush=True)  # noqa: E731
    res: dict = {}
    held_out = lm_batch(cfg, batch, seq, seed=SEED, step=TRAIN_STEPS, device=device)
    try:
        # the initial model's loss on the batch of step 12, which (a) never sees
        with torch.no_grad():
            init = lm.init_params(torch.Generator(device=device).manual_seed(SEED), cfg,
                                  device=device)
            init_loss = float(lm.loss_fn(init, held_out, cfg))
        del init
        # (a) 12 steps, an async checkpoint at the last
        _fresh_peak(on_card)
        held = torch.cuda.memory_allocated() / 2**30 if on_card else None
        a = train(cfg, loop, log=log, device=device)
        peak = _peak_gib(on_card)
        losses = a["losses"]
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"losses {losses}")
        if not statistics.mean(losses[-3:]) < statistics.mean(losses[:3]):
            raise AssertionError(f"the loss did not fall: {losses}")
        step_ms = statistics.median(a["step_s"]) * 1e3
        res["a"] = {"losses": losses, "step_ms": [v * 1e3 for v in a["step_s"]],
                    "median_step_ms": step_ms, "tok_s": batch * seq / step_ms * 1e3,
                    "peak_gib": peak, "held_gib": held,
                    "save_ms": [v * 1e3 for v in a["save_s"]]}
        mem = (f"peak {peak:.2f} GiB ({held:.2f} GiB held when it began)" if on_card
               else "peak memory not measured (CPU)")
        print(f"[train] (a) {cfg.name} quant=bnn, {TRAIN_STEPS} steps of {batch} x {seq} "
              f"tokens: loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of first 3 "
              f"{statistics.mean(losses[:3]):.4f}, last 3 {statistics.mean(losses[-3:]):.4f}); "
              f"median step {step_ms:.1f} ms ({res['a']['tok_s']:.0f} tokens/s), steps "
              f"{', '.join(f'{v * 1e3:.0f}' for v in a['step_s'])} ms; {mem}; the async save "
              f"blocks the host {', '.join(f'{v * 1e3:.0f}' for v in a['save_s'])} ms",
              flush=True)
        model, opt_state = a["params"], a["opt_state"]
        del a
        shutil.rmtree(loop.checkpoint_dir, ignore_errors=True)

        # (c) train -> serve on the kernels, and compile() holds copies
        prompts = serve.prompts(cfg, BATCH, PROMPT, SEED)
        cms = {e: compiler.compile(cfg, model, compiler.HardwareTarget(engine=e), device=device)
               for e in ("packed", "reference")}
        _reset_counts()
        packed = _lockstep_logits(cms["packed"], prompts, TRAIN_TICKS + 1)
        n_packed = _counts()
        variants = _fused_variants()
        per_run = layers * 5 * (TRAIN_TICKS + 1)
        _check_launches(device, {**n_packed, "fused by variant": variants},
                        {"fused_bnn_matmul": per_run, "hamming_matmul": 0,
                         "fused by variant": {"popc": 0, "b1": per_run}}, "trained packed")
        _reset_counts()
        ref = _lockstep_logits(cms["reference"], prompts, TRAIN_TICKS + 1)
        _check_launches(device, _counts(), {"fused_bnn_matmul": 0, "hamming_matmul": 0},
                        "trained reference")
        logits = packed["logits"][0]
        if not torch.isfinite(logits[:, : cfg.vocab_size]).all():
            raise AssertionError("trained prefill logits not finite")
        if not np.array_equal(packed["generated"], ref["generated"]) or not torch.equal(
                logits, ref["logits"][0]):
            raise AssertionError("trained packed != trained reference (tokens or prefill logits)")
        step_fn = make_train_step(cfg, OptConfig(), loop)
        more = step_fn(model, opt_state, held_out, TRAIN_STEPS)
        moved = {e: not torch.equal(cm.prefill(prompts)[0], w)
                 for (e, cm), w in zip(cms.items(), (logits, ref["logits"][0]))}
        if any(moved.values()) or more["skipped"]:
            raise AssertionError(f"a step after compile() moved the compiled models: {moved}")
        res["c"] = {"fused_launches": n_packed["fused_bnn_matmul"], "fused_by_variant": variants,
                    "decode_tok_s": packed["decode_tok_s"], "ref_decode_tok_s": ref["decode_tok_s"],
                    "held_out_loss": {"initial": init_loss, "trained": more["loss"]}}
        print(f"[train] (c) trained model compiled to packed and reference: {BATCH} prompts x "
              f"{TRAIN_TICKS} ticks, tokens and prefill logits equal; packed launched "
              f"{n_packed['fused_bnn_matmul']} fused ({layers * 5} per prefill or tick, by "
              f"variant {variants}), reference 0; {packed['decode_tok_s']:.1f} tok/s (reference "
              f"{ref['decode_tok_s']:.1f}); one more step left both compiled models' prefill "
              f"logits as they were; its batch (step {TRAIN_STEPS}, unseen in training) has "
              f"loss {init_loss:.4f} on the initial model, {more['loss']:.4f} on the trained "
              f"one", flush=True)
        del cms, model, opt_state, packed, ref
        _release({})

        # (b) resume == never-failed at RESUME_LAYERS: a clean run, a fault, a preemption
        short = dataclasses.replace(cfg, n_layers=min(RESUME_LAYERS, layers))
        b_loop = dataclasses.replace(loop, checkpoint_every=TRAIN_EVERY,
                                     checkpoint_dir=os.path.join(root, "b0"))
        clean = train(short, b_loop, log=log, device=device)
        want = dict(_train_state(clean))
        clean_save_ms = [v * 1e3 for v in clean["save_s"]]
        del clean
        _release({})
        calls = {"n": 0}

        def fault(step):
            calls["n"] += 1
            if step == TRAIN_FAULT_STEP and calls["n"] <= TRAIN_FAULT_STEP + 1:
                raise RuntimeError("injected node failure")

        b = train(short, dataclasses.replace(b_loop, checkpoint_dir=os.path.join(root, "b")),
                  fault_hook=fault, log=log, device=device)
        bad = _state_mismatches(b, want)
        if b["restarts"] != 1 or len(b["restore_s"]) != 1 or bad:
            raise AssertionError(f"fault run: restarts {b['restarts']}, restores "
                                 f"{len(b['restore_s'])}, leaves != the clean run's: {bad[:5]}")
        restore_ms = b["restore_s"][0] * 1e3
        del b
        _release({})

        def preempt(step):
            if step == TRAIN_PREEMPT_STEP:  # SIGTERM, as a scheduler sends it
                os.kill(os.getpid(), signal.SIGTERM)

        p_loop = dataclasses.replace(b_loop, checkpoint_dir=os.path.join(root, "p"))
        p1 = train(short, p_loop, fault_hook=preempt, log=log, device=device)
        if not p1["preempted"] or p1["final_step"] != TRAIN_PREEMPT_STEP:
            raise AssertionError(f"preemption: preempted={p1['preempted']} at {p1['final_step']}")
        del p1
        _release({})
        p2 = train(short, p_loop, log=log, device=device)
        bad = _state_mismatches(p2, want)
        if p2["preempted"] or p2["final_step"] != TRAIN_STEPS - 1 or bad:
            raise AssertionError(f"resumed run: final step {p2['final_step']}, leaves != the "
                                 f"clean run's: {bad[:5]}")
        res["b"] = {"layers": short.n_layers, "restore_ms": restore_ms, "leaves": len(want),
                    "save_ms": clean_save_ms, "resumed_restore_ms": p2["restore_s"][0] * 1e3}
        del p2
        for name in ("b0", "b", "p"):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
        _release({})
        print(f"[train] (b) {short.n_layers} of {layers} layers, {TRAIN_STEPS} steps with a "
              f"checkpoint every {TRAIN_EVERY} (saves block the host "
              f"{', '.join(f'{v:.0f}' for v in clean_save_ms)} ms): fault at step "
              f"{TRAIN_FAULT_STEP} -> 1 restart from the step-3 checkpoint, and SIGTERM at step "
              f"{TRAIN_PREEMPT_STEP} -> checkpoint, exit, resume: all {len(want)} parameter and "
              f"optimizer-state tensors torch.equal to the clean run's in both; a restore takes "
              f"{restore_ms:.0f} ms ({res['b']['resumed_restore_ms']:.0f} ms after the "
              f"preemption)", flush=True)

        # (d) the paper MLP: trained on the card, read out on every engine
        gen = torch.Generator(device=device).manual_seed(SEED)
        mlp_steps = 60 if smoke else MLP_STEPS
        params, mlp_s, mlp_losses = _train_mlp(device, gen, mlp_steps)
        x, y = bnn_image_batch(MLP_EVAL, shape=(28, 28, 1), step=10_000, device=device)
        x = x.reshape(MLP_EVAL, -1)
        want_logits = paper.mlp_forward_infer(params, x, paper.MLPConfig(), "reference")
        for engine in MLP_ENGINES:
            if not torch.equal(paper.mlp_forward_infer(params, x, paper.MLPConfig(), engine),
                               want_logits):
                raise AssertionError(f"trained MLP on {engine} != reference")
        acc = float((want_logits.argmax(dim=-1) == y).float().mean())
        if not acc > 0.5:
            raise AssertionError(f"trained MLP accuracy {acc}")
        res["d"] = {"accuracy": acc, "train_s": mlp_s, "loss_first": mlp_losses[0],
                    "loss_last": mlp_losses[-1]}
        print(f"[train] (d) paper MLP 784-500-250-10, {mlp_steps} steps x {MLP_BATCH} in "
              f"{mlp_s:.2f} s (loss {mlp_losses[0]:.4f} -> {mlp_losses[-1]:.4f}): {MLP_EVAL} "
              f"held-out images, reference == {', '.join(MLP_ENGINES)} bit for bit, accuracy "
              f"{acc:.3f}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    res["fused_bnn_matmul"] = res["c"]["fused_launches"] if on_card else 0
    print(json.dumps({"train": res}), flush=True)
    print(f"[train] phase {res['seconds']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 11: train breadth -- every other family trains at full width
# ---------------------------------------------------------------------------

# (family, arch, decoder layers kept (None: all), peak lr, OptConfig
# fields). Depth is cut where memory or time force it: mamba2's 64
# layers would take ~1.3-2.0 s per step each 8 (8 of 64 kept); a
# qwen3-moe layer holds 2.42 B expert parameters, 47 GiB of training
# state at one layer (1 of 94 kept), with the reference's factored second
# moment. The peak lr is each model's, from a sweep of 1e-3, 3e-3 and
# 1e-2 over these 4 steps on the card (tools/train_probe.py, PERF.md):
# one at which the last loss lies below the first and the loss of a
# held-out batch falls too (internvl2's last loss rose at 1e-3 and 1e-2,
# qwen3-moe's at 3e-3 and 1e-2, seamless's held-out loss at 1e-2;
# mamba2's gradient went NaN at every lr before the SSD's causal mask
# moved ahead of its exp).
TRAIN_BREADTH = (
    ("VLM", "internvl2-1b", None, 3e-3, {}),
    ("enc-dec", "seamless-m4t-large-v2", None, 3e-3, {}),
    ("SSM", "mamba2-2.7b", 8, 1e-3, {}),
    ("MoE", "qwen3-moe-235b-a22b", 1, 1e-3, {"factored": True}),
)
# 4 steps with no warmup, so that three updates land before the last
# loss; then 8 served ticks. An Adam step moves a logit by about lr x
# sum|h| ~ lr x d, so the smoke configs (d 56-64, a loss that moves ~0.1
# from one 16-token batch to the next) rehearse at 1e-2
BREADTH_STEPS, BREADTH_SMOKE_LR, BREADTH_TICKS = 4, 1e-2, 8


def _served_equal(cfg, model, src, extra, device: str, what: str) -> dict:
    """Train -> serve: ``packed`` against ``reference`` on the trained
    weights, 8 seeded prompts and ``BREADTH_TICKS`` lockstep ticks. An LM
    is compiled to each engine (fused ``b1`` on every programmed
    projection); an enc-dec model serves through ``EncDecServing`` with
    ``bnn_engine`` set to each (the Hamming kernel, ``b1``). Tokens and
    prefill logits must be equal; returns packed's launches by kernel."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import compiler
    from repro_torch.launch import serve
    from repro_torch.models.layers import FFN, Attention

    prompts = serve.prompts(cfg, BATCH, PROMPT, SEED)
    gen = BREADTH_TICKS + 1
    runs, launches = {}, {}
    for engine in ("packed", "reference"):
        if cfg.is_encdec:
            c = dataclasses.replace(cfg, bnn_engine=engine)
            served = serve.EncDecServing(model, c, src, compiler.HardwareTarget(engine=engine),
                                         torch.device(device))
        else:
            served = compiler.compile(cfg, model, compiler.HardwareTarget(engine=engine),
                                      device=device)
        _reset_counts()
        runs[engine] = serve.lockstep(served, prompts, gen, extra)
        launches[engine] = {**_counts(), "fused by variant": _fused_variants(),
                            "hamming by variant": _hamming_variants()}
        del served
    if cfg.is_encdec:
        prefill_n, tick_n = _hamming_per_step(cfg)
        ham, fused = prefill_n + BREADTH_TICKS * tick_n, 0
    else:
        # fused [q|k|v] and o per attention mixer, w1, w3 and w2 per dense FFN
        ham, fused = 0, gen * sum(2 * isinstance(blk.mixer, Attention)
                                  + 3 * isinstance(blk.ffn, FFN) for blk in model.blocks)
    _check_launches(device, launches["packed"],
                    {"fused_bnn_matmul": fused, "hamming_matmul": ham,
                     "fused by variant": {"popc": 0, "b1": fused},
                     "hamming by variant": {"popc": 0, "b1": ham}}, f"{what} trained packed")
    _check_launches(device, {k: launches["reference"][k] for k in ("fused_bnn_matmul",
                                                                   "hamming_matmul")},
                    {"fused_bnn_matmul": 0, "hamming_matmul": 0}, f"{what} trained reference")
    packed, ref = runs["packed"], runs["reference"]
    logits = packed["prefill_logits"]
    if not torch.isfinite(logits[:, : cfg.vocab_size]).all():
        raise AssertionError(f"{what}: trained prefill logits not finite")
    if not np.array_equal(packed["generated"], ref["generated"]) or not torch.equal(
            logits, ref["prefill_logits"]):
        raise AssertionError(f"{what}: trained packed != trained reference (tokens or prefill "
                             f"logits)")
    return {"fused_bnn_matmul": launches["packed"]["fused_bnn_matmul"],
            "hamming_matmul": launches["packed"]["hamming_matmul"],
            "decode_tok_s": packed["decode_tok_s"], "ref_decode_tok_s": ref["decode_tok_s"]}


def train_breadth_phase(device: str = "cuda", smoke: bool = False) -> dict:
    """Training breadth on the card: internvl2-1b (24 layers, 256 patch
    embeddings before each row), seamless-m4t-large-v2 (24 + 24 layers,
    512 source frames per row), mamba2-2.7b (8 of 64 layers) and
    qwen3-moe-235b-a22b (1 of 94 layers, ``OptConfig(factored=True)``),
    each at full width with ``quant="bnn"``, jnp attention and per-layer
    remat, through ``repro_torch.train.train`` on 8 x 128 tokens without
    checkpoints (``checkpoint_every=0``: a qwen3-moe layer's state is 30
    GB):

    (a) 4 steps: every loss finite and the last below the first; the
        median step ms, tokens/s (the 8 x 128 text tokens) and peak GiB;
    (b) the same 4 steps again from the same seed in the loop's
        deterministic mode: every parameter and optimizer-state tensor
        ``torch.equal`` to (a)'s (the resume invariant, for the MoE
        dispatch and the SSD scan's ops);
    (c) train -> serve: ``packed`` == ``reference`` on the trained
        weights (``_served_equal``): internvl2's 24 layers launch 120
        fused ``b1`` per prefill or tick, qwen3-moe's layer 2, mamba2
        none, seamless 432 Hamming ``b1`` per prefill and 216 per tick.

    The peak lr is each model's (``TRAIN_BREADTH``). ``device="cpu",
    smoke=True`` rehearses it on the smoke configs with 8 x 16 tokens at
    lr 1e-2 (launch counts and device memory are then not read).
    Returns the phase's numbers; ``fused_bnn_matmul`` and
    ``hamming_matmul`` are (c)'s packed launches."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import frontend_embeds
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, train

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    seq = 16 if smoke else PROMPT
    res: dict = {"card": smi("name,power.limit") if on_card else None}
    log = lambda line: print(line, flush=True)  # noqa: E731
    for family, arch, layers, lr, opt_kw in TRAIN_BREADTH:
        t_family = time.perf_counter()
        base = get_smoke_config(arch) if smoke else get_config(arch)
        cfg = dataclasses.replace(base, quant="bnn", attn_impl="jnp", remat=True,
                                  n_layers=min(layers or base.n_layers, base.n_layers))
        opt_cfg = OptConfig(**opt_kw)
        loop = TrainLoopConfig(total_steps=BREADTH_STEPS, batch_size=BATCH, seq_len=seq,
                               peak_lr=BREADTH_SMOKE_LR if smoke else lr,
                               warmup_steps=0, checkpoint_every=0, seed=SEED)
        what = (f"{family} {cfg.name}, {cfg.n_encoder_layers} + {cfg.n_layers}" if cfg.is_encdec
                else f"{family} {cfg.name}, {cfg.n_layers} of {base.n_layers}") + " layers"
        # (a)
        _fresh_peak(on_card)
        a = train(cfg, loop, opt_cfg, log=log, device=device)
        peak = _peak_gib(on_card)
        losses = a["losses"]
        if len(losses) != BREADTH_STEPS or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{what}: losses {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{what}: the loss did not fall: {losses}")
        step_ms = statistics.median(a["step_s"]) * 1e3
        want = dict(_train_state(a))
        model = a["params"]
        del a
        gc.collect()
        # (b)
        b = train(cfg, loop, opt_cfg, log=log, device=device)
        bad = _state_mismatches(b, want)
        if b["losses"] != losses or bad:
            raise AssertionError(f"{what}: the second run differs: losses {b['losses']} vs "
                                 f"{losses}; leaves {bad[:5]}")
        del b, want
        gc.collect()
        # (c)
        # source frames for an enc-dec model, patch embeddings for a VLM
        embeds = (frontend_embeds(cfg, BATCH, generator=torch.Generator().manual_seed(SEED),
                                  device=device)
                  if cfg.is_encdec or cfg.frontend == "vision" else None)
        src, extra = (embeds, None) if cfg.is_encdec else (None, embeds)
        served = _served_equal(cfg, model.requires_grad_(False), src, extra, device, what)
        del model, embeds, src, extra
        _release({})
        res[family] = {"arch": arch, "layers": [cfg.n_encoder_layers, cfg.n_layers],
                       "peak_lr": loop.peak_lr, "losses": losses, "median_step_ms": step_ms,
                       "tok_s": BATCH * seq / step_ms * 1e3, "peak_gib": peak, **served,
                       "seconds": time.perf_counter() - t_family}
        mem = "not measured (CPU)" if peak is None else f"{peak:.2f} GiB"
        print(f"[train breadth] {what}, peak lr {loop.peak_lr:g}: loss "
              f"{' -> '.join(f'{v:.4f}' for v in losses)}; "
              f"median step {step_ms:.1f} ms ({res[family]['tok_s']:.0f} tokens/s); peak {mem}; "
              f"a second run equal on every parameter and optimizer-state tensor; trained "
              f"packed == reference over {BATCH} prompts x {BREADTH_TICKS} ticks "
              f"({served['fused_bnn_matmul']} fused, {served['hamming_matmul']} Hamming "
              f"launches); {res[family]['seconds']:.1f} s", flush=True)
    res["seconds"] = time.perf_counter() - t_phase
    res["fused_bnn_matmul"] = sum(res[f]["fused_bnn_matmul"] for f, *_ in TRAIN_BREADTH)
    res["hamming_matmul"] = sum(res[f]["hamming_matmul"] for f, *_ in TRAIN_BREADTH)
    print(json.dumps({"train_breadth": res}), flush=True)
    print(f"[train breadth] phase {res['seconds']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 12: breadth -- MoE FFNs, the Mamba-2 SSD mixer, the hybrid stack
# ---------------------------------------------------------------------------

BREADTH_MOE = "qwen3-moe-235b-a22b"
# full width, depth cut to 2 of its 94 layers: 9.81 GB of fp32 latents
# per layer plus 4.98 GB of embedding and untied head
BREADTH_MOE_LAYERS = 2
BREADTH_SSM = "mamba2-2.7b"
# full width, depth cut to 8 of its 64 layers (the train breadth phase's
# cut): at full depth this model took most of the phase's 177 s and runs
# no kernel (time for the distributed phase)
BREADTH_SSM_LAYERS = 8
# at full width one 8-layer repeat holds ~176 GB of fp32 latents, which
# no single card holds: its smoke config runs here
BREADTH_HYBRID = "jamba-1.5-large-398b"
# request prompts: qwen3-moe's as the serve phase's (64-128 tokens); the
# Mamba stack's below the conv tail (3), below the 80 SSD heads and past
SSM_PROMPTS = (1, 2, 3, 7, 33, 64, 79, 96)


def _breadth_requests(cfg, lengths) -> list:
    """One request per prompt length, tokens from ``REQUEST_SEED``."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(REQUEST_SEED)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=GEN) for i, n in enumerate(lengths)]


def _requests_equal_alone(model, reqs, what: str, tag: str = "breadth") -> dict:
    """The request path's invariants on ``model``: the requests in 8
    slots, and again with one more request of higher priority arriving
    after 3 ticks (it evicts a running one, restored later); every
    generation equals the request served alone (``serve()`` with one
    slot). Returns the counts and the 8-slot run's wall time and tok/s."""
    import dataclasses

    from repro_torch.device import synchronize
    from repro_torch.serving import SchedulerConfig

    max_len = max(len(r.prompt) for r in reqs) + GEN
    alone = {}
    for r in reqs:
        se1 = model.serve(max_batch=1, max_len=max_len)
        st = se1.submit(r)
        se1.drain()
        alone[r.rid] = tuple(st.generated)
    synchronize(model.device)
    t0 = time.perf_counter()
    se = model.serve(max_batch=BATCH, max_len=max_len)
    states = [se.submit(r) for r in reqs]
    se.drain()
    synchronize(model.device)
    wall = time.perf_counter() - t0
    toks = sum(len(st.generated) for st in states)
    for st in states:
        if tuple(st.generated) != alone[st.request.rid]:
            raise AssertionError(f"{what}: request {st.request.rid} in {BATCH} slots != alone")
    late = dataclasses.replace(reqs[0], rid=len(reqs), priority=5)
    alone[late.rid] = alone[reqs[0].rid]
    se = model.serve(max_batch=BATCH, max_len=max_len, scheduler=SchedulerConfig())
    states = [se.submit(r) for r in reqs]
    for _ in range(3):
        se.step()
    states.append(se.submit(late))
    se.drain()
    stats = se.stats()
    if not stats.evictions == stats.restores >= 1:
        raise AssertionError(f"{what}: evictions {stats.evictions}, restores {stats.restores}")
    for st in states:
        if tuple(st.generated) != alone[st.request.rid]:
            raise AssertionError(f"{what}: request {st.request.rid} after evict/restore != alone")
    print(f"[{tag}] {what} request path: {len(reqs)} requests (prompts "
          f"{min(len(r.prompt) for r in reqs)}-{max(len(r.prompt) for r in reqs)}, gen {GEN}) in "
          f"{BATCH} slots in {wall * 1e3:.1f} ms ({toks / wall:.1f} tok/s), each == alone; with a "
          f"priority arrival after 3 ticks: {stats.evictions} eviction(s) and restore(s), every "
          f"request == alone", flush=True)
    return {"requests": len(reqs), "evictions": stats.evictions, "wall_ms": wall * 1e3,
            "tok_s": toks / wall}


def _fused_per_step(cfg) -> int:
    """Fused BitLinear launches per prefill or decode tick on ``packed``:
    [q|k|v] and o per attention layer, w1, w3 and w2 per dense-FFN layer
    (Mamba projections and MoE experts are plain products)."""
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    return sum(2 * (k.mixer == "attn") + 3 * (not k.moe and cfg.d_ff > 0) for k in kinds)


def _breadth_model(cfg, params_fn, reqs, device: str, what: str, keep: dict | None = None,
                   extra_embeds=None, tag: str = "breadth") -> dict:
    """One configuration of the breadth phase: on ``packed``, the lockstep
    batch (8 x 128 tokens, after ``extra_embeds`` when given, ``GEN - 1``
    ticks) read for its fused and flash launches, then -- unless
    ``reqs`` is None -- a profiled tick and the request path (token
    prompts); then on ``reference`` (one model at a time, so the expert
    stacks are never held twice) the same lockstep batch, whose tokens
    and prefill logits must equal packed's bit for bit. ``keep`` receives
    the packed lockstep's ``generated`` tokens and ``prefill_logits``;
    ``tag`` heads the printed lines."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import compiler
    from repro_torch.launch import serve

    on_card = device == "cuda"
    tokens = serve.prompts(cfg, BATCH, PROMPT, SEED)
    _fresh_peak(on_card)
    packed = compiler.compile(cfg, params_fn(), compiler.HardwareTarget(engine="packed"),
                              device=device)
    serve.lockstep(packed, tokens, 2, extra_embeds)  # warm-up: start-up costs out of the timed run
    _reset_counts()
    lock = serve.lockstep(packed, tokens, GEN, extra_embeds)
    counts = {**_counts(), "flash_attention": _flash_count()}
    variants = {"fused_bnn_matmul": _fused_variants(), "flash_attention": _flash_variants()}
    peak = _peak_gib(on_card)
    n_fused = _fused_per_step(cfg) * GEN
    n_flash = sum(k.mixer == "attn" for k in cfg.pattern) * cfg.n_repeats \
        if cfg.attn_impl == "pallas" else 0
    _check_launches(device, {**counts, **{f"{k} by variant": v for k, v in variants.items()}},
                    {"fused_bnn_matmul": n_fused, "hamming_matmul": 0, "flash_attention": n_flash,
                     "fused_bnn_matmul by variant": {"popc": 0, "b1": n_fused},
                     "flash_attention by variant": {"fma": 0, "sm90": n_flash}},
                    f"{what} packed lockstep")
    logits, gen = lock["prefill_logits"], lock["generated"]
    if keep is not None:
        keep.update(generated=gen, prefill_logits=logits[:, : cfg.vocab_size].cpu())
    if not torch.isfinite(logits[:, : cfg.vocab_size]).all():
        raise AssertionError(f"{what}: prefill logits not finite")
    if gen.shape != (BATCH, GEN) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise AssertionError(f"{what}: generations of shape {gen.shape} out of the vocab")
    tick_ms = lock["decode_s"] * 1e3 / (GEN - 1)
    peak_txt = "not measured" if peak is None else f"{peak:.2f} GiB"
    print(f"[{tag}] {what} packed lockstep batch={BATCH} prompt={PROMPT} gen={GEN}: prefill "
          f"{lock['prefill_s'] * 1e3:.2f} ms, decode {GEN - 1} ticks {lock['decode_s'] * 1e3:.2f} "
          f"ms ({lock['decode_tok_s']:.1f} tok/s, {tick_ms:.2f} ms/tick); launches {counts}: "
          f"{n_fused // GEN} fused per prefill or tick, {n_flash} flash per prefill, by variant "
          f"{variants}; peak {peak_txt}", flush=True)
    res = {"prefill_ms": lock["prefill_s"] * 1e3, "decode_tok_s": lock["decode_tok_s"],
           "tick_ms": tick_ms, "launches": counts, "by_variant": variants, "peak_gib": peak}
    if reqs is not None:
        res["profile"] = profile_decode(packed, tokens, tick_ms, extra_embeds)
        _reset_counts()
        res["requests"] = _requests_equal_alone(packed, reqs, what, tag)
        res["request_launches"] = {**_counts(), "flash_attention": _flash_count()}
        if on_card and n_fused and (res["request_launches"]["fused_bnn_matmul"] == 0
                                    or _fused_variants()["popc"]):
            raise AssertionError(f"{what}: request path launched {res['request_launches']}, "
                                 f"fused by variant {_fused_variants()}")
    _release({"compiled": packed})
    del packed
    _fresh_peak(on_card)
    ref_model = compiler.compile(dataclasses.replace(cfg, quant="bnn"), params_fn(),
                                 compiler.HardwareTarget(engine="reference"), device=device)
    ref = serve.lockstep(ref_model, tokens, GEN, extra_embeds)
    _release({"compiled": ref_model})
    del ref_model
    if not np.array_equal(ref["generated"], gen):
        bad = int((ref["generated"] != gen).sum())
        raise AssertionError(f"{what}: packed generations differ from reference in {bad} tokens")
    if not torch.equal(ref["prefill_logits"], logits):
        raise AssertionError(f"{what}: packed prefill logits differ from the reference engine's")
    res["reference_decode_tok_s"] = ref["decode_tok_s"]
    print(f"[{tag}] {what} reference lockstep: prefill {ref['prefill_s'] * 1e3:.2f} ms, decode "
          f"{ref['decode_tok_s']:.1f} tok/s; packed == reference: all {gen.size} tokens and the "
          f"prefill logits bit for bit", flush=True)
    return res


def breadth_phase(device: str = "cuda", smoke: bool = False) -> dict:
    """The MoE, Mamba-2 and hybrid decoder stacks through ``compile()`` /
    ``serve()`` on seeded random weights:

    (a) qwen3-moe-235b-a22b at full width (d 4096, 64 / 4 heads of 64,
        128 experts top-8, d_ff 1536, vocab 151936), depth cut to 2
        layers, with ``attn_impl="jnp"`` and ``"pallas"`` (flash ``sm90``
        at D = 64): lockstep on ``packed`` (fused ``b1`` for [q|k|v] and
        o) == ``reference``, 8 slots == alone, evict/restore unchanged;
        one layer's attention at its prefill shape through the flash
        kernel == through the plain ops within ATTN_TOL;
    (b) mamba2-2.7b at full width, 8 of 64 layers: the same checks, with
        request prompts of 1 to 96 tokens; it launches no kernel (no
        projection of a Mamba stack is a BitLinear, in the reference
        either), and its profiled tick gives its device time;
    (c) jamba-1.5-large-398b's smoke config on ``packed`` == ``reference``,
        8 slots == alone across attention, Mamba and MoE caches,
        ``prefill_continue`` raising ``PrefixContinuationError``, and a
        2-replica prefix-routed fleet serving it with no graft, each
        request == a single engine's.

    ``device="cpu", smoke=True`` rehearses it at the smoke configs' size.
    Returns the phase's numbers; ``fused_bnn_matmul`` and
    ``flash_attention`` are (a)'s packed lockstep launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import compiler
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import lm

    t_phase = time.perf_counter()

    def config(arch):
        return get_smoke_config(arch) if smoke else get_config(arch)

    def seeded(cfg):
        return lambda: lm.init_params(torch.Generator(device=device).manual_seed(SEED), cfg,
                                      device=device)

    res: dict = {}
    moe_cfg = config(BREADTH_MOE)
    if not smoke:
        moe_cfg = dataclasses.replace(moe_cfg, n_layers=BREADTH_MOE_LAYERS)
    lengths = np.random.default_rng(REQUEST_SEED).integers(PROMPT // 2, PROMPT + 1, size=BATCH)
    moe_reqs = _breadth_requests(moe_cfg, [int(n) for n in lengths])
    by_impl: dict = {}
    for impl in ("jnp", "pallas"):
        cfg = dataclasses.replace(moe_cfg, attn_impl=impl)
        res[f"a_{impl}"] = _breadth_model(cfg, seeded(cfg), moe_reqs, device,
                                          f"(a) {cfg.name} {cfg.n_layers} layers attn={impl}",
                                          keep=by_impl.setdefault(impl, {}))
    # packed == reference above holds flash against flash: the flash
    # kernel is held against the plain ops here, at this model's shape
    # (64 heads, GQA groups of 16), within ATTN_TOL (and in check_flash
    # against its plain version at the same shape). Whole-model logits
    # get no bound: a binarized sign or an expert choice that flips
    # moves a logit by O(1); their difference is reported.
    attn_diff = _attention_impls_agree(moe_cfg, device, f"(a) {moe_cfg.name}")
    logit_diff = (by_impl["pallas"]["prefill_logits"]
                  - by_impl["jnp"]["prefill_logits"]).abs().max().item()
    same = int((by_impl["pallas"]["generated"] == by_impl["jnp"]["generated"]).sum())
    res["a_pallas"].update(attn_vs_jnp=attn_diff, prefill_logits_vs_jnp=logit_diff,
                           tokens_equal_jnp=same)
    print(f"[breadth] (a) {moe_cfg.name} attn=pallas vs attn=jnp: one layer's attention at "
          f"B={BATCH} H={moe_cfg.n_heads} KV={moe_cfg.n_kv_heads} S={PROMPT} D={moe_cfg.hd} "
          f"max |diff| {attn_diff:.4g} (tol {ATTN_TOL}); binarized prefill logits max |diff| "
          f"{logit_diff:.4g}, tokens equal in {same} of {BATCH * GEN}", flush=True)

    ssm_cfg = config(BREADTH_SSM)
    if not smoke:
        ssm_cfg = dataclasses.replace(ssm_cfg, n_layers=BREADTH_SSM_LAYERS)
    res["b"] = _breadth_model(ssm_cfg, seeded(ssm_cfg), _breadth_requests(ssm_cfg, SSM_PROMPTS),
                              device, f"(b) {ssm_cfg.name} {ssm_cfg.n_layers} layers")
    launched = res["b"]["launches"], res["b"]["request_launches"]
    if any(n for counts in launched for n in counts.values()):
        raise AssertionError(f"(b) {ssm_cfg.name} launched kernels: {launched}")
    print(f"[breadth] (b) {ssm_cfg.name} launched no kernel (lockstep {launched[0]}, request "
          f"path {launched[1]})", flush=True)

    hyb = get_smoke_config(BREADTH_HYBRID)
    res["c"] = _breadth_model(hyb, seeded(hyb), _breadth_requests(hyb, SSM_PROMPTS), device,
                              f"(c) {hyb.name}")
    model = compiler.compile(hyb, seeded(hyb)(), compiler.HardwareTarget(engine="packed"),
                             device=device)
    _, pre = model.prefill(torch.zeros((1, 8), dtype=torch.int64))
    try:
        model.prefill_continue(torch.zeros((1, 4), dtype=torch.int64), pre)
    except lm.PrefixContinuationError as e:
        refused = str(e)
    else:
        raise AssertionError(f"(c) {hyb.name}: prefill_continue over Mamba slots did not raise")
    fleet = build_fleet(hyb, seeded(hyb)(), device)
    reqs = fleet_requests(hyb)
    states, wall = drive_fleet(fleet, reqs, device)
    st = fleet.stats()
    if st.finished != len(reqs) or st.grafted_tokens or st.prefix_hits or any(
            r.serving.supports_prefix_graft for r in fleet.replicas.values()):
        raise AssertionError(f"(c) fleet finished {st.finished} of {len(reqs)}, grafted "
                             f"{st.grafted_tokens} tokens, prefix hits {st.prefix_hits}")
    se = model.serve(max_batch=BATCH, max_len=PREFIX_LEN + SUFFIX[1] + GEN)
    single = [se.submit(r) for r in reqs]
    se.drain()
    for f, s_ in zip(states, single, strict=True):
        if tuple(f.generated) != tuple(s_.generated):
            raise AssertionError(f"(c) fleet request {f.request.rid} != single engine")
    res["c"]["fleet_tok_s"] = sum(len(s.generated) for s in states) / wall
    print(f"[breadth] (c) {hyb.name}: prefill_continue refused ({refused[:80]}...); fleet 2 "
          f"replicas x {BATCH} slots, routing=prefix: {len(reqs)} requests, no graft (prefix "
          f"hits {st.prefix_hits}, grafted {st.grafted_tokens}), every request == a single "
          f"engine's", flush=True)
    del model, fleet, se

    res["seconds"] = time.perf_counter() - t_phase
    res["fused_bnn_matmul"] = sum(res[f"a_{i}"]["launches"]["fused_bnn_matmul"]
                                  for i in ("jnp", "pallas"))
    res["flash_attention"] = res["a_pallas"]["launches"]["flash_attention"]
    print(json.dumps({"breadth": res}), flush=True)
    print(f"[breadth] phase {res['seconds']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 13: frontends -- the encoder-decoder stack and the vision frontend
# ---------------------------------------------------------------------------

# full width and depth: 24 + 24 layers, d 1024, 16 heads of 64, d_ff
# 8192, vocab 256206, 512 frames per utterance (8.1 GB of fp32 latents)
FRONTEND_ENCDEC = "seamless-m4t-large-v2"
# full width and depth: 24 layers, d 896, 14 / 2 heads of 64, d_ff 4864,
# vocab 151655, 256 patch embeddings per image (2.5 GB)
FRONTEND_VLM = "internvl2-1b"


def _hamming_per_step(cfg) -> tuple[int, int]:
    """Hamming launches of one enc-dec prefill and one decode tick on
    ``packed``: every binarized projection through ``binary_vmm`` --
    prefill: q, k, v, o, w1, w3, w2 per encoder layer and self q/k/v/o,
    cross q/k/v/o, w1, w3, w2 per decoder layer; a tick: the decoder's
    less the cross k/v (cached)."""
    return 7 * cfg.n_encoder_layers + 11 * cfg.n_layers, 9 * cfg.n_layers


def _encdec_lockstep(model, cfg, src, tokens, device: str, what: str,
                     profile: bool = False) -> dict:
    """The enc-dec model on ``cfg.bnn_engine`` through the serve CLI's
    ``EncDecServing``: a warm-up, then the lockstep batch (``GEN - 1``
    ticks) with the Hamming and flash launches it made, and with
    ``profile`` a profiled tick. Returns the lockstep's results with
    ``launches``, ``by_variant``, ``peak_gib`` and ``profile``."""
    import torch

    from repro_torch import compiler
    from repro_torch.kernels import xnor_matmul
    from repro_torch.launch import serve

    on_card = device == "cuda"
    served = serve.EncDecServing(model, cfg, src, compiler.HardwareTarget(engine=cfg.bnn_engine),
                                 torch.device(device))
    serve.lockstep(served, tokens, 2)  # warm-up: start-up costs out of the timed run
    _fresh_peak(on_card)
    _reset_counts()
    lock = serve.lockstep(served, tokens, GEN)
    lock["launches"] = {**_counts(), "flash_attention": _flash_count()}
    lock["by_variant"] = {"hamming_matmul": dict(xnor_matmul.launches_by_variant),
                          "flash_attention": _flash_variants()}
    lock["peak_gib"] = _peak_gib(on_card)
    lock["profile"] = None
    tick_ms = lock["decode_s"] * 1e3 / (GEN - 1)
    if cfg.bnn_engine == "packed":
        prefill_n, tick_n = _hamming_per_step(cfg)
        n_ham = prefill_n + (GEN - 1) * tick_n
        # self, cross and encoder attention per layer, in the prefill
        n_flash = (cfg.n_encoder_layers + 2 * cfg.n_layers) if cfg.attn_impl == "pallas" else 0
        _check_launches(device, {**lock["launches"], **{f"{k} by variant": v
                                                        for k, v in lock["by_variant"].items()}},
                        {"fused_bnn_matmul": 0, "hamming_matmul": n_ham, "flash_attention": n_flash,
                         "hamming_matmul by variant": {"popc": 0, "b1": n_ham},
                         "flash_attention by variant": {"fma": 0, "sm90": n_flash}},
                        f"{what} lockstep")
    peak = lock["peak_gib"]
    print(f"[frontends] {what} lockstep batch={BATCH} prompt={PROMPT} over "
          f"{src.shape[1]} frames gen={GEN}: prefill {lock['prefill_s'] * 1e3:.2f} ms, decode "
          f"{GEN - 1} ticks {lock['decode_s'] * 1e3:.2f} ms ({lock['decode_tok_s']:.1f} tok/s, "
          f"{tick_ms:.2f} ms/tick); launches {lock['launches']}, by variant "
          f"{lock['by_variant']}; peak "
          f"{'not measured' if peak is None else f'{peak:.2f} GiB'}", flush=True)
    if profile:
        lock["profile"] = profile_decode(served, tokens, tick_ms)
    return lock


# enc-dec decode == prefill at one position, full-precision projections:
# the two round p and v in another order, 0.0098 of the largest logit on
# the smoke config (CPU) and 0.0146 at full depth (an H100). A planted
# decode fault moves it further: the last prompt row stale 0.049 / 0.028,
# one position early 0.21 / 0.073, another utterance's cross K/V 1.01 /
# 0.67 (smoke / full depth). The bound lies between the sound readings
# and every fault's at both sizes: 0.02 of the largest logit.
DECODE_REL = 0.02


def _decode_matches_prefill(model, base, src, tokens, device: str, what: str) -> dict:
    """Decode at position ``PROMPT - 1`` over a prefill of the first
    ``PROMPT - 1`` tokens == a prefill of all ``PROMPT`` (the reference's
    invariant, its tests/test_smoke_archs.py), with ``attn_impl="jnp"``
    and full-precision projections: max |diff| within ``DECODE_REL`` of
    the largest logit and every greedy token equal. The same decode with
    each of three planted faults -- the last prompt row of the self cache
    zeroed, the step one position early, the cross K/V rolled onto
    another utterance -- must exceed the bound, so the check is shown to
    catch them."""
    import dataclasses

    import torch

    from repro_torch.models import encdec

    cfg = dataclasses.replace(base, attn_impl="jnp")
    n = PROMPT - 1
    tok = torch.as_tensor(tokens, device=device)

    def stale(caches):
        for key in encdec.SELF_KEYS:
            caches[key][:, :, n - 1].zero_()

    def cross_of_another(caches):
        for key in encdec.CROSS_KEYS:
            caches[key].copy_(caches[key].roll(1, dims=1))

    def decode(pos=n, plant=None):
        caches = encdec.graft_prefill_caches(
            encdec.init_cache(cfg, BATCH, n + 1, src.shape[1], device=device), pre)
        if plant is not None:
            plant(caches)
        return encdec.decode_step(model, tok[:, n], pos, caches, cfg)[0][:, : cfg.vocab_size]

    with torch.no_grad():
        want = encdec.prefill(model, src, tok, cfg)[0][:, : cfg.vocab_size]
        _, pre = encdec.prefill(model, src, tok[:, :n], cfg)
        got = decode()
        faults = {name: (decode(**kw) - want).abs().max().item() for name, kw in (
            ("last prompt row stale", {"plant": stale}),
            ("one position early", {"pos": n - 1}),
            ("another utterance's cross K/V", {"plant": cross_of_another}))}
    del pre
    top = want.abs().max().item()
    diff = (got - want).abs().max().item()
    bound = DECODE_REL * top
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    # the reference's smoke-size rule, reported: at full depth it is not
    # the reference's claim
    smoke_rule = bool(torch.allclose(got, want, atol=5e-2, rtol=5e-2))
    print(f"[frontends] {what} quant=none: decode at position {n} vs a prefill of {n + 1} "
          f"tokens: max |diff| {diff:.4g} ({diff / top:.4g} of max |logit| {top:.4g}; bound "
          f"{bound:.4g} = {DECODE_REL} x max |logit|; the reference's smoke rule, allclose 5e-2: "
          f"{smoke_rule}), greedy tokens equal in {same} of {BATCH}; planted faults: "
          + ", ".join(f"{k} {v:.4g} ({v / top:.4g})" for k, v in faults.items()), flush=True)
    if not diff <= bound or same != BATCH:
        raise AssertionError(f"{what}: decode at position {n} vs a prefill of {n + 1} tokens: "
                             f"max |diff| {diff} (bound {bound}), greedy tokens equal in {same} "
                             f"of {BATCH}")
    missed = [k for k, v in faults.items() if not v > bound]
    if missed:
        raise AssertionError(f"{what}: the decode == prefill bound {bound} misses the planted "
                             f"faults {missed}: {faults}")
    return {"max_abs_diff": diff, "bound": bound, "max_abs_logit": top, "tokens_equal": same,
            "within_5e-2": smoke_rule, "faults": faults}


def frontends_phase(device: str = "cuda", smoke: bool = False) -> dict:
    """The encoder-decoder stack and the vision frontend, on seeded random
    weights and frontend embeddings:

    (a) seamless-m4t-large-v2 at full width and depth, served as the
        serve CLI serves it (``EncDecServing``: no compile, every
        projection on ``cfg.bnn_engine``): 8 utterances of 512 frames, 8
        x 128 prompt tokens, 31 ticks, with ``attn_impl="jnp"`` and
        ``"pallas"``. ``packed`` runs every projection through the Hamming
        kernel (``b1``; flash ``sm90`` for the encoder, self- and
        cross-attention with pallas); its tokens and prefill logits equal
        the ``reference`` engine's bit for bit. Decode == prefill at one
        position (``_decode_matches_prefill``). One encoder layer's, one
        cross-attention layer's and one decoder self-attention layer's
        attention through flash == the plain ops' within ATTN_TOL;
    (b) internvl2-1b at full width and depth compiled on ``packed``, on
        both attention paths: 8 x (256 patch embeddings + 128 tokens), 31
        ticks from position 384, == ``reference`` bit for bit (fused
        ``b1``, flash ``sm90`` at GQA groups of 7); then (on the jnp path)
        the request path with token prompts, 8 requests with one
        preemption, each == alone.

    ``device="cpu", smoke=True`` rehearses it at the smoke configs' size.
    Returns the phase's numbers; ``hamming_matmul``, ``fused_bnn_matmul``
    and ``flash_attention`` are the launches of (a)'s packed and (b)'s
    packed lockstep runs."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import frontend_embeds
    from repro_torch.launch import serve
    from repro_torch.models import encdec, lm

    t_phase = time.perf_counter()
    on_card = device == "cuda"

    def config(arch):
        return get_smoke_config(arch) if smoke else get_config(arch)

    def frames(cfg):
        return frontend_embeds(cfg, BATCH, generator=torch.Generator().manual_seed(SEED),
                               device=device)

    res: dict = {"card": smi("name,power.limit") if on_card else None}

    # (a) the encoder-decoder stack
    base = config(FRONTEND_ENCDEC)
    _fresh_peak(on_card)
    model = encdec.init_params(torch.Generator(device=device).manual_seed(SEED), base,
                               device=device)
    src = frames(base)
    tokens = serve.prompts(base, BATCH, PROMPT, SEED)
    what = f"(a) {base.name} {base.n_encoder_layers}+{base.n_layers} layers"
    # decode ticks run the same ops on both attention paths (decode
    # attention is plain), so the profiled tick and the request path run
    # once, on the first
    for impl in ("jnp", "pallas"):
        runs = {}
        for engine in ("packed", "reference"):
            cfg = dataclasses.replace(base, quant="bnn", bnn_engine=engine, attn_impl=impl)
            runs[engine] = _encdec_lockstep(model, cfg, src, tokens, device,
                                            f"{what} attn={impl} {engine}",
                                            profile=engine == "packed" and impl == "jnp")
        packed, ref = runs["packed"], runs["reference"]
        logits, gen = packed["prefill_logits"], packed["generated"]
        if not torch.isfinite(logits[:, : base.vocab_size]).all():
            raise AssertionError(f"{what} attn={impl}: prefill logits not finite")
        if gen.shape != (BATCH, GEN) or gen.min() < 0 or gen.max() >= base.vocab_size:
            raise AssertionError(f"{what} attn={impl}: generations of shape {gen.shape} out of "
                                 f"the vocab")
        if not np.array_equal(ref["generated"], gen):
            bad = int((ref["generated"] != gen).sum())
            raise AssertionError(f"{what} attn={impl}: packed generations differ from "
                                 f"reference in {bad} tokens")
        if not torch.equal(ref["prefill_logits"], logits):
            raise AssertionError(f"{what} attn={impl}: packed prefill logits differ from the "
                                 f"reference engine's")
        print(f"[frontends] {what} attn={impl}: packed == reference: all {gen.size} tokens and "
              f"the prefill logits bit for bit", flush=True)
        res[f"a_{impl}"] = {
            engine: {k: r[k] for k in ("prefill_s", "decode_s", "decode_tok_s", "launches",
                                       "by_variant", "peak_gib", "profile")}
            for engine, r in runs.items()}

    res["a_decode_vs_prefill"] = _decode_matches_prefill(model, base, src, tokens, device, what)
    # frames that do not fill the plain ops' key chunk are padded and
    # masked by position, which turns their attention causal (the
    # reference's rule, ROADMAP queue 3; the smoke config's 16 frames
    # under a 32-key chunk); flash has no such rule, so the plain ops run
    # one chunk of exactly the frames there. At full width 512 frames
    # fill the 512-key chunk: the model's own setting.
    ss = src.shape[1]
    chunk = base.attn_chunk if ss % base.attn_chunk == 0 else ss
    enc_diff = _attention_impls_agree(base, device, f"{what} encoder", ss, ss, causal=False,
                                      chunk=chunk)
    cross_diff = _attention_impls_agree(base, device, f"{what} cross-attention", PROMPT, ss,
                                        causal=False, chunk=chunk)
    # the decoder's self-attention: the prompt over itself, causal
    self_diff = _attention_impls_agree(base, device, f"{what} decoder self-attention")
    res["a_attn_vs_jnp"] = {"encoder": enc_diff, "cross": cross_diff, "decoder_self": self_diff}
    print(f"[frontends] {what} attn=pallas vs attn=jnp (key chunk {chunk}; the decoder's "
          f"{base.attn_chunk}): one encoder layer's "
          f"attention (B={BATCH} H={base.n_heads} S={ss} D={base.hd}, non-causal) max |diff| "
          f"{enc_diff:.4g}; one cross-attention layer's (Sq={PROMPT} over Skv={ss}) "
          f"{cross_diff:.4g}; one decoder self-attention layer's (S={PROMPT}, causal) "
          f"{self_diff:.4g} (tol {ATTN_TOL})", flush=True)
    del model, src
    _release({})

    # (b) the vision frontend
    vlm = config(FRONTEND_VLM)
    extra = frames(vlm)
    lengths = np.random.default_rng(REQUEST_SEED).integers(PROMPT // 2, PROMPT + 1, size=BATCH)
    reqs = _breadth_requests(vlm, [int(n) for n in lengths])
    for impl in ("jnp", "pallas"):
        cfg = dataclasses.replace(vlm, attn_impl=impl)
        res[f"b_{impl}"] = _breadth_model(
            cfg, lambda c=cfg: lm.init_params(torch.Generator(device=device).manual_seed(SEED), c,
                                              device=device),
            reqs if impl == "jnp" else None, device,
            f"(b) {cfg.name} {cfg.n_layers} layers + {cfg.frontend_len} patches attn={impl}",
            extra_embeds=extra, tag="frontends")
    attn_diff = _attention_impls_agree(vlm, device, f"(b) {vlm.name}", PROMPT + vlm.frontend_len,
                                       PROMPT + vlm.frontend_len)
    res["b_attn_vs_jnp"] = attn_diff
    print(f"[frontends] (b) {vlm.name} attn=pallas vs attn=jnp: one layer's attention at "
          f"B={BATCH} H={vlm.n_heads} KV={vlm.n_kv_heads} S={PROMPT + vlm.frontend_len} "
          f"D={vlm.hd} max |diff| {attn_diff:.4g} (tol {ATTN_TOL})", flush=True)

    res["seconds"] = time.perf_counter() - t_phase
    res["hamming_matmul"] = sum(res[f"a_{i}"]["packed"]["launches"]["hamming_matmul"]
                                for i in ("jnp", "pallas"))
    res["fused_bnn_matmul"] = sum(res[f"b_{i}"]["launches"]["fused_bnn_matmul"]
                                  for i in ("jnp", "pallas"))
    res["flash_attention"] = (res["a_pallas"]["packed"]["launches"]["flash_attention"]
                              + res["b_pallas"]["launches"]["flash_attention"])
    print(json.dumps({"frontends": res}), flush=True)
    print(f"[frontends] phase {res['seconds']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 14: distributed -- torch.distributed on the card
# ---------------------------------------------------------------------------

DIST_TIMEOUT_S = 420  # one spawned world's deadline (init included)
DIST_RANKS = 2  # the ranks of (c), (d) and (e), sharing the card
PROBE_TIMEOUT_S = 120
# (c): qwen3-moe-235b-a22b at full width, one layer; 8 x 128 prompt
# tokens, 4 rows per rank. At capacity factor 16 moe_ffn's per-sequence
# capacity is 128 (drop-free) and EP's per (src, dst) 32768
EP_ARCH = "qwen3-moe-235b-a22b"
EP_DROPFREE = 16.0
EP_TOL = 3e-2  # the reference's own test of EP against moe_ffn (test_multidevice.py)
# (d): tinyllama-1.1b, one stage of 11 layers per rank, 4 microbatches of 2 x 128
PIPE_MICRO = 4
# (e): each rank's training batch, 2 x 128 tokens, for the gradient tree
CAR_ROWS = 2


def _one_rank_group(device: str, workdir: str) -> dict:
    """(a) a one-rank group in this process (NCCL on the card, gloo in a
    CPU rehearsal) through a 1-D mesh: every collective and the
    compressed all-reduce give their n = 1 identities."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.compression import (
        _dequantize,
        _quantize,
        compressed_all_reduce_mean,
        ef_init,
    )
    from repro_torch.launch.mesh import init_distributed, make_test_mesh

    backend = init_distributed(0, 1, store=dist.FileStore(os.path.join(workdir, "store"), 1),
                               device=device, timeout_s=120)
    try:
        mesh = make_test_mesh((1,), ("data",), device=device)
        axis = (mesh, "data")
        x = torch.randn((1024, 512), generator=torch.Generator().manual_seed(SEED)).to(device)
        got = {
            "ring_all_reduce_mean": col.ring_all_reduce_mean(x, axis),
            "reduce_scatter_mean": col.reduce_scatter_mean(x, axis, scatter_dim=1),
            "all_gather_dim": col.all_gather_dim(x, axis, dim=1),
            "ppermute_shift": col.ppermute_shift(x, axis, 1),
            "all_to_all": col.all_to_all(x[None], axis)[0],
        }
        bad = [k for k, v in got.items() if not torch.equal(v, x)]
        red, ef = compressed_all_reduce_mean({"w": x}, ef_init({"w": x}), axis)
        payload = _dequantize(*_quantize(x))
        if not (torch.equal(red["w"], payload) and torch.equal(ef["w"], x - payload)):
            bad.append("compressed_all_reduce_mean")
        if bad:
            raise AssertionError(f"(a) one-rank {backend} group: not the identity: {bad}")
    finally:
        dist.destroy_process_group()
    print(f"[distributed] (a) one-rank {backend} group on {device}: {', '.join(got)} and "
          "compressed_all_reduce_mean (== dequantize(quantize(x)), residual x - it) give "
          "their n = 1 identities", flush=True)
    return {"backend": backend, "identities": [*got, "compressed_all_reduce_mean"]}


def _probe_op(op: str, rank: int, dev) -> list[float]:
    """One collective straight on gloo (never through ``collectives``'
    staging), on two ranks, with tensors on ``dev``; returns what the
    rank got, and what it should have got."""
    import torch
    import torch.distributed as dist

    n, other = 4, 1 - rank
    me = torch.full((n,), float(rank + 1), device=dev)
    if op == "all_reduce":
        out = me.clone()
        dist.all_reduce(out)
        want = [3.0] * n
    elif op == "all_gather_into_tensor":
        out = torch.empty(2 * n, device=dev)
        dist.all_gather_into_tensor(out, me)
        want = [1.0] * n + [2.0] * n
    elif op == "reduce_scatter_tensor":
        out = torch.empty(n, device=dev)
        dist.reduce_scatter_tensor(out, torch.cat([me, me]))
        want = [3.0] * n
    elif op == "all_to_all_single":
        out = torch.empty(2, device=dev)
        dist.all_to_all_single(out, torch.tensor([10.0 * rank, 10.0 * rank + 1], device=dev))
        want = [float(rank), 10.0 + rank]
    else:  # send_recv
        out = torch.empty(n, device=dev)
        for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, me, other),
                                            dist.P2POp(dist.irecv, out, other)]):
            work.wait()
        want = [float(other + 1)] * n
    return out.cpu().tolist(), want


def _probe_rank(rank: int, world: int, progress: str) -> dict:
    """Each op of ``collectives.OPS`` probed in turn on this rank's device;
    rank 0 writes the answers after each op, so a world that dies on one
    leaves the others'."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.collectives import OPS

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    out: dict = {}
    for op in OPS:
        try:
            got, want = _probe_op(op, rank, dev)
            out[op] = "device" if got == want else f"wrong values {got}, expected {want}"
        except Exception as e:  # the probe's answer: gloo does not run this op on such tensors
            out[op] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
        dist.barrier()
        if rank == 0:
            with open(progress, "w") as f:
                json.dump(out, f)
    return out


def _probe_gloo(device: str, workdir: str) -> dict:
    """(b) which collectives gloo runs on this device's tensors: a
    two-rank world probes each op; an op that failed, or that a rank died
    or hung in, goes through pinned host memory
    (``collectives.GLOO_CUDA_OPS`` must name exactly the ones that ran)."""
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import WorldError, run_local_world

    progress = os.path.join(workdir, "probe0.json")
    try:
        answers = run_local_world(_probe_rank, 2, workdir=workdir, payload=progress,
                                  device=device, backend="gloo", timeout_s=PROBE_TIMEOUT_S)[0]
    except WorldError as e:
        answers = json.load(open(progress)) if os.path.exists(progress) else {}
        died = next((op for op in collectives.OPS if op not in answers), None)
        if died is None:
            raise
        answers[died] = f"the world died or hung: {str(e)[:200]}"
        for op in collectives.OPS:
            answers.setdefault(op, "not probed (an earlier op's world died)")
    direct = {op for op, a in answers.items() if a == "device"}
    if device == "cuda" and direct != collectives.GLOO_CUDA_OPS:
        raise AssertionError(f"(b) gloo ran {sorted(direct)} on CUDA tensors directly, but "
                             f"collectives.GLOO_CUDA_OPS says {sorted(collectives.GLOO_CUDA_OPS)}: "
                             f"{answers}")
    if device == "cpu" and direct != set(collectives.OPS):
        raise AssertionError(f"(b) gloo refused CPU tensors: {answers}")
    transport = {op: "device" if op in direct else "pinned host" for op in collectives.OPS}
    print(f"[distributed] (b) gloo on {device} tensors, probed on 2 ranks: {answers}; "
          f"transport {transport}", flush=True)
    return {"probe": answers, "transport": transport}


def _ep_part(rank: int, world: int, device: str, smoke: bool) -> dict:
    """(c) on this rank: qwen3-moe's layer with this rank's experts, its
    rows through the EP layer against ``moe_ffn`` with every expert, a
    planted fault, the prefill under the mesh context (fused launches
    counted), and the drop share at the default capacity."""
    import dataclasses

    import torch

    from repro_torch import compiler
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import synchronize
    from repro_torch.distributed import ep
    from repro_torch.distributed.hints import activation_hints
    from repro_torch.kernels import rows as rows_lib
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import ACT_DTYPE, rms_norm

    on_card = device == "cuda"
    dev = torch.device(device)
    base = get_smoke_config(EP_ARCH) if smoke else get_config(EP_ARCH)
    cfg = dataclasses.replace(base, n_layers=1, moe_impl="ep_shard_map",
                              moe_capacity_factor=EP_DROPFREE)
    mesh = make_test_mesh((world,), ("model",), device=device, backend="gloo")
    _fresh_peak(on_card)
    params = lm.init_params(torch.Generator(device=device).manual_seed(SEED), cfg, device=device)
    model = compiler.compile(cfg, params, compiler.HardwareTarget(engine="packed"), device=device)
    del params
    cfg = model.cfg  # quant "bnn" on packed
    rows = BATCH // world
    tokens = torch.as_tensor(serve.prompts(cfg, BATCH, PROMPT, SEED))[rank * rows:(rank + 1) * rows]
    tokens = tokens.to(dev)
    # the MoE layer's input, as prefill computes it
    blk = model.params.blocks[0]
    h = model.params.embed[tokens].to(ACT_DTYPE)
    positions = torch.arange(PROMPT, device=dev)
    with torch.no_grad():
        mix, _ = lm._mix(blk, rms_norm(h, blk.norm1, cfg.norm_eps), positions, cfg,
                         model.executor(rows))
        hn = rms_norm(h + mix, blk.norm2, cfg.norm_eps)
        single = moe_lib.moe_ffn(blk.ffn, hn, cfg)[0].float()
        single_logits = model.prefill(tokens)[0]
    peak_all_experts = _peak_gib(on_card)
    ep.shard_experts_(model.params, mesh)
    _fresh_peak(on_card)
    bound = EP_TOL + EP_TOL * single.abs()

    def timed(fn):
        synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        synchronize(dev)
        return out, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        ep.ep_moe_ffn(blk.ffn, hn, cfg, mesh)  # warm-up
        (y, aux), ep_ms = timed(lambda: ep.ep_moe_ffn(blk.ffn, hn, cfg, mesh))
        err = (y.float() - single).abs()
        # a planted fault: the received buckets rolled by one rank
        real = ep.all_to_all
        ep.all_to_all = lambda t, axis=None: torch.roll(real(t, axis), 1, dims=0)
        try:
            y_fault = ep.ep_moe_ffn(blk.ffn, hn, cfg, mesh)[0]
        finally:
            ep.all_to_all = real
        fault_err = (y_fault.float() - single).abs()
        with activation_hints(mesh):
            model.prefill(tokens)  # warm-up
            _reset_counts()
            (logits, _), prefill_ms = timed(lambda: model.prefill(tokens))
            counts = _counts()
        cfg125 = dataclasses.replace(cfg, moe_capacity_factor=base.moe_capacity_factor)
        cap = ep.capacity(rows * PROMPT, cfg125, world)
        x2d = hn.reshape(-1, cfg.d_model)
        keep = ep._local_dispatch(x2d, rows_lib.matmul(x2d.float(), blk.ffn.router), world,
                                  cfg.moe_experts // world, cfg.moe_top_k, cap)[-1]
        (y125, _), ep125_ms = timed(lambda: ep.ep_moe_ffn(blk.ffn, hn, cfg125, mesh))
    if not bool((err <= bound).all()):
        raise AssertionError(f"(c) rank {rank}: EP vs moe_ffn max |diff| {err.max().item()} "
                             f"beyond {EP_TOL} + {EP_TOL}|ref|")
    if bool((fault_err <= bound).all()):
        raise AssertionError(f"(c) rank {rank}: the planted fault stayed within the bound")
    if not (torch.isfinite(logits).all() and torch.isfinite(y125).all()):
        raise AssertionError(f"(c) rank {rank}: non-finite EP prefill logits or output")
    _check_launches(device, counts, {"fused_bnn_matmul": _fused_per_step(cfg),
                                     "hamming_matmul": 0}, f"(c) rank {rank} EP prefill")
    return {
        "rows": rows, "experts_local": cfg.moe_experts // world,
        "cap_dropfree": ep.capacity(rows * PROMPT, cfg, world), "cap_default": cap,
        "ep_vs_moe_ffn_max_abs": err.max().item(), "ref_max_abs": single.abs().max().item(),
        "fault_max_abs": fault_err.max().item(),
        "fault_beyond_bound": (fault_err - bound).max().item(),
        "prefill_logits_vs_single_max_abs": (logits - single_logits).abs().max().item(),
        "ep_layer_ms": ep_ms, "ep_layer_default_cap_ms": ep125_ms, "prefill_ms": prefill_ms,
        "drop_share_default_cap": 1.0 - keep.float().mean().item(), "aux": aux.item(),
        "fused_bnn_matmul": counts["fused_bnn_matmul"], "peak_gib": _peak_gib(on_card),
        "peak_gib_all_experts": peak_all_experts,
    }


def _pipe_part(rank: int, world: int, device: str, smoke: bool) -> dict:
    """(d) on this rank: tinyllama's stage ``rank`` (its blocks only,
    programmed on ``packed``) in GPipe; the last stage's hidden state
    against the single-process run of every block."""
    import dataclasses

    import torch

    from repro_torch import compiler
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import synchronize
    from repro_torch.distributed.pipeline import bubble_fraction, gpipe, stage_split
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.layers import ACT_DTYPE

    on_card = device == "cuda"
    dev = torch.device(device)
    cfg = dataclasses.replace(get_smoke_config(ARCH) if smoke else get_config(ARCH), quant="bnn")
    _fresh_peak(on_card)
    params = lm.init_params(torch.Generator(device=device).manual_seed(SEED), cfg, device=device)
    compiled = compiler.compile(cfg, params, compiler.HardwareTarget(engine="packed"),
                                device=device)
    del params
    engine = compiled.engine
    tokens = torch.as_tensor(serve.prompts(cfg, BATCH, PROMPT, SEED)).to(dev)
    positions = torch.arange(PROMPT, device=dev)
    blocks = list(compiled.params.blocks)
    with torch.no_grad():
        h = compiled.params.embed[tokens].to(ACT_DTYPE)
        synchronize(dev)
        t0 = time.perf_counter()
        seq = lm.run_blocks(blocks, h, positions, cfg, engine)
        synchronize(dev)
        seq_ms = (time.perf_counter() - t0) * 1e3
    lo, hi = stage_split(cfg.n_layers, world)[rank]
    stage = blocks[lo:hi]
    del compiled, blocks  # this rank keeps its stage's blocks only

    def stage_fn(stage_blocks, x):
        return lm.run_blocks(stage_blocks, x, positions, cfg, engine)

    pipe = gpipe(stage_fn, None, n_microbatches=PIPE_MICRO)
    with torch.no_grad():
        pipe(stage, h)  # warm-up
        _reset_counts()
        synchronize(dev)
        t0 = time.perf_counter()
        y = pipe(stage, h)
        synchronize(dev)
        pipe_ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
    equal = torch.equal(y, seq)
    ticks = world - 1 + PIPE_MICRO
    per_layer = _fused_per_step(cfg) // cfg.n_layers
    _check_launches(device, counts, {"fused_bnn_matmul": ticks * (hi - lo) * per_layer,
                                     "hamming_matmul": 0}, f"(d) rank {rank} GPipe")
    diff = (y.float() - seq.float()).abs().max().item()
    return {"layers": [lo, hi], "equal": equal, "max_abs_diff": diff,
            "pipe_ms": pipe_ms, "sequential_ms": seq_ms,
            "bubble": bubble_fraction(world, PIPE_MICRO), "ticks": ticks,
            "fused_bnn_matmul": counts["fused_bnn_matmul"], "peak_gib": _peak_gib(on_card)}


def _car_part(rank: int, world: int, device: str, smoke: bool) -> dict:
    """(e) on this rank: tinyllama's full gradient tree from one training
    step on the rank's own batch, compressed-all-reduced twice; the mean
    against the two ranks' dequantized payloads bit for bit, the residual
    against x - dequantize(quantize(x)) bit for bit."""
    import dataclasses

    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import lm_batch
    from repro_torch.device import synchronize
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.compression import (
        _dequantize,
        _quantize,
        compressed_all_reduce_mean,
        ef_init,
    )
    from repro_torch.models import lm

    on_card = device == "cuda"
    dev = torch.device(device)
    cfg = dataclasses.replace(get_smoke_config(ARCH) if smoke else get_config(ARCH), quant="bnn")
    _fresh_peak(on_card)
    model = lm.init_params(torch.Generator(device=device).manual_seed(SEED), cfg, device=device)
    model.requires_grad_(True)
    batch = lm_batch(cfg, CAR_ROWS, PROMPT, seed=SEED, step=rank, device=device)
    loss = lm.loss_fn(model, batch, cfg)
    loss.backward()
    grads = lm.take_grad_tree(model)
    loss = float(loss.detach())
    del model
    _fresh_peak(on_card)
    n = sum(g.numel() for g in tree_lib.leaves(grads))
    group = col.group_of(None)

    def call(ef):
        synchronize(dev)
        t0 = time.perf_counter()
        out = compressed_all_reduce_mean(grads, ef, None)
        synchronize(dev)
        return out, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        (red, ef1), ms1 = call(ef_init(grads))
        mean_ok = resid_ok = True
        for path, g in tree_lib.leaves_with_paths(grads):
            payload = _dequantize(*_quantize(g.float()))
            other = col.ppermute_shift(payload, None, 1)
            pair = (payload, other) if rank == 0 else (other, payload)
            want = (pair[0] + pair[1]) / torch.tensor(2.0, device=dev)
            mean_ok &= torch.equal(tree_lib.get(red, path), want)
            resid_ok &= torch.equal(tree_lib.get(ef1, path), g.float() - payload)
        del red
        (red2, ef2), ms2 = call(ef1)
        carried_ok = True
        for path, g in tree_lib.leaves_with_paths(grads):
            x = g.float() + tree_lib.get(ef1, path)
            carried_ok &= torch.equal(tree_lib.get(ef2, path), x - _dequantize(*_quantize(x)))
    if not (mean_ok and resid_ok and carried_ok):
        raise AssertionError(f"(e) rank {rank}: mean bit for bit {mean_ok}, residual {resid_ok}, "
                             f"carried residual {carried_ok}")
    leaf = tree_lib.leaves(grads)[0]
    return {"params": n, "loss": loss, "ms": [ms1, ms2],
            "gb_s": [n * 4 / (ms / 1e3) / 1e9 for ms in (ms1, ms2)],
            "transport": col.transport("all_reduce", leaf, group),
            "peak_gib": _peak_gib(on_card)}


def _dist_rank(rank: int, world: int, payload: dict) -> dict:
    """(c), (d) and (e) on one rank of the two sharing the card."""
    import torch

    device, smoke = payload["device"], payload["smoke"]
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = {}
    for part, fn in (("c", _ep_part), ("d", _pipe_part), ("e", _car_part)):
        t0 = time.perf_counter()
        out[part] = fn(rank, world, device, smoke)
        out[part]["seconds"] = time.perf_counter() - t0
    return out


def distributed_phase(device: str = "cuda", smoke: bool = False) -> dict:
    """The distribution layer (``repro_torch.distributed``) on
    ``torch.distributed``:

    (a) a one-rank NCCL group on cuda:0: every collective and the
        compressed all-reduce on device tensors give their n = 1
        identities (the only NCCL run: NCCL refuses two ranks on one
        card);
    (b) two ranks sharing the card on gloo (spawned, a FileStore in a
        temp dir, a deadline on the init and the join): which collectives
        gloo runs on CUDA tensors, each probed; the rest go through
        pinned host memory, and ``collectives.GLOO_CUDA_OPS`` must say so;
    (c) expert-parallel MoE at qwen3-moe-235b-a22b's full width (d 4096,
        128 experts top-8, d_ff 1536), one layer, 64 experts per rank:
        ``lm.prefill`` of 4 of 8 x 128 prompt rows per rank with
        ``moe_impl="ep_shard_map"`` under the mesh context (the attention
        projections on the fused ``b1`` kernel, counted); at drop-free
        capacity the EP layer within ``EP_TOL`` (+ ``EP_TOL`` |ref|) of
        ``moe_ffn`` with every expert on the same rows, a planted fault
        (the received buckets rolled by one rank) beyond it; the drop
        share at the default capacity 1.25;
    (d) GPipe at tinyllama-1.1b full width and depth: 2 stages of 11
        layers on programmed ``packed`` weights (fused ``b1``), 4
        microbatches of 2 x 128 rows, the last stage's hidden state
        ``torch.equal`` to the single-process run;
    (e) the compressed all-reduce of tinyllama-1.1b's full gradient tree
        (1.1 B fp32 per rank, one training step on each rank's batch):
        the mean equal bit for bit to the two ranks' dequantized payloads'
        (p0 + p1) / 2, the residual to x - dequantize(quantize(x)), a
        second call carrying it; ms and GB/s per all-reduce.

    The ranks' kernel launches are counted in the ranks (reset before,
    read after each measured run) and returned. ``device="cpu",
    smoke=True`` rehearses it on gloo at the smoke configs' size."""
    import tempfile

    t_phase = time.perf_counter()
    from repro_torch.launch.mesh import run_local_world

    _fresh_peak(device == "cuda")
    res: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        res["a"] = _one_rank_group(device, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        res["b"] = _probe_gloo(device, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_local_world(_dist_rank, DIST_RANKS, workdir=tmp,
                                payload={"device": device, "smoke": smoke}, device=device,
                                backend="gloo", timeout_s=DIST_TIMEOUT_S)
    c = [r["c"] for r in ranks]
    res["c"] = {"ranks": c, "ep_vs_moe_ffn_max_abs": max(r["ep_vs_moe_ffn_max_abs"] for r in c),
                "fault_max_abs": min(r["fault_max_abs"] for r in c),
                "drop_share_default_cap": sum(r["drop_share_default_cap"] for r in c) / len(c)}
    print(f"[distributed] (c) EP, {c[0]['experts_local']} experts and {c[0]['rows']} x {PROMPT} "
          f"rows per rank, capacity {c[0]['cap_dropfree']} per (src, dst): EP layer vs moe_ffn "
          f"max |diff| {res['c']['ep_vs_moe_ffn_max_abs']:.4g} (bound {EP_TOL} + {EP_TOL}|ref|, "
          f"|ref| <= {max(r['ref_max_abs'] for r in c):.4g}); planted fault max |diff| "
          f"{res['c']['fault_max_abs']:.4g}, beyond the bound by "
          f"{min(r['fault_beyond_bound'] for r in c):.4g}; EP layer "
          f"{[round(r['ep_layer_ms'], 2) for r in c]} ms, prefill under the mesh "
          f"{[round(r['prefill_ms'], 2) for r in c]} ms ({[r['fused_bnn_matmul'] for r in c]} "
          f"fused launches), logits vs single-process max |diff| "
          f"{max(r['prefill_logits_vs_single_max_abs'] for r in c):.4g}; at capacity "
          f"{c[0]['cap_default']} (factor 1.25) drop share "
          f"{res['c']['drop_share_default_cap']:.4f}, EP layer "
          f"{[round(r['ep_layer_default_cap_ms'], 2) for r in c]} ms; peak "
          f"{[r['peak_gib_all_experts'] for r in c]} GiB with every expert, "
          f"{[r['peak_gib'] for r in c]} GiB with 1/{len(c)}", flush=True)
    d = [r["d"] for r in ranks]
    if not all(r["equal"] for r in d):
        raise AssertionError(f"(d) GPipe != the single-process run: max |diff| "
                             f"{[r['max_abs_diff'] for r in d]}")
    res["d"] = {"ranks": d, "equal": True}
    print(f"[distributed] (d) GPipe {len(d)} stages {[r['layers'] for r in d]}, "
          f"{PIPE_MICRO} microbatches of {BATCH // PIPE_MICRO} x {PROMPT}: last stage == "
          f"single-process run bit for bit; {[round(r['pipe_ms'], 2) for r in d]} ms against "
          f"{d[0]['sequential_ms']:.2f} ms in one process, bubble {d[0]['bubble']:.2f} "
          f"({d[0]['ticks']} ticks); fused launches {[r['fused_bnn_matmul'] for r in d]}; peak "
          f"{[r['peak_gib'] for r in d]} GiB", flush=True)
    e = [r["e"] for r in ranks]
    res["e"] = {"ranks": e}
    print(f"[distributed] (e) compressed all-reduce of {e[0]['params']} fp32 gradients per rank "
          f"(transport {e[0]['transport']}): mean == (p0 + p1) / 2 and residual == x - "
          f"dequantize(quantize(x)) bit for bit, the second call's residual carried; "
          f"{[[round(m, 1) for m in r['ms']] for r in e]} ms, "
          f"{[[round(g, 3) for g in r['gb_s']] for r in e]} GB/s; peak "
          f"{[r['peak_gib'] for r in e]} GiB", flush=True)
    res["fused_bnn_matmul"] = sum(r["fused_bnn_matmul"] for r in (*c, *d))
    res["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"distributed": res}), flush=True)
    print(f"[distributed] phase {res['seconds']:.1f} s", flush=True)
    return res


DRYRUN_ARCH = "tinyllama-1.1b"
DRYRUN_PEAK_TOL = 0.10  # predicted vs measured peak memory of one training step
PROFILED_PRODUCTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
DRYRUN_CELL, DRYRUN_MESH = "train_4k", (16, 16)  # (f)'s production cell
DRYRUN_CHILD_TIMEOUT_S = 300
# (a): (f)'s record from a process with no card (run with CUDA_VISIBLE_DEVICES='')
DRYRUN_CHILD = ("import json, sys; sys.path[:0] = [{src!r}, {root!r}]; import chip_smoke; "
                "rec, s = chip_smoke._production_record({smoke!r}); "
                "print(json.dumps({{'record': rec, 'trace_s': s}}))")


def _ep_bytes_rank(rank: int, world: int, payload: dict) -> dict:
    """(e) on one rank: qwen3-moe's MoE layer at full width with this
    rank's experts (seeded random weights), its rows through the EP
    layer once; returns the bytes it handed to the all-to-alls."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed import ep
    from repro_torch.launch.mesh import make_test_mesh

    device = payload["device"]
    cfg = get_smoke_config(EP_ARCH) if payload["smoke"] else get_config(EP_ARCH)
    mesh = make_test_mesh((world,), ("model",), device=device, backend="gloo")
    layer, x = _ep_inputs(cfg, world, payload["rows"], device, rank)
    moved = {"bytes": 0, "calls": 0}
    real = (ep.all_to_all, ep.all_to_all0)

    def counted(fn):
        def call(t, axis=None):
            moved["bytes"] += t.numel() * t.element_size()
            moved["calls"] += 1
            return fn(t, axis)
        return call

    ep.all_to_all, ep.all_to_all0 = (counted(f) for f in real)
    try:
        with torch.no_grad():
            y = ep.ep_moe_ffn(layer, x, cfg, mesh)[0]
    finally:
        ep.all_to_all, ep.all_to_all0 = real
    if not bool(torch.isfinite(y).all()):
        raise AssertionError(f"(e) rank {rank}: non-finite EP output")
    return moved


def _ep_inputs(cfg, world: int, rows: int, device, rank: int = 0):
    """This rank's MoE layer (its E / world experts, the whole router)
    and its (rows, PROMPT, d) bf16 input, seeded; ``meta`` shapes only
    for ``device="meta"``."""
    import torch

    from repro_torch.models import moe as moe_lib

    e, d, f = cfg.moe_experts // world, cfg.d_model, cfg.d_ff
    meta = device == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(SEED + rank)

    def draw(*shape, dtype=torch.float32, scale=1.0):
        if meta:
            return torch.empty(shape, dtype=dtype, device="meta")
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    layer = moe_lib.MoE(draw(d, cfg.moe_experts, scale=d ** -0.5), draw(e, d, f, scale=d ** -0.5),
                        draw(e, d, f, scale=d ** -0.5), draw(e, f, d, scale=f ** -0.5))
    return layer, draw(rows, PROMPT, d, dtype=torch.bfloat16)


def dryrun_phase(device: str = "cuda", smoke: bool = False) -> dict:
    """(a)-(f) of the dry-run's step analysis (see the module docstring).
    ``device="cpu", smoke=True`` rehearses it at the smoke config's size
    ((c) needs the card's allocator and is left out there)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed.partitioner import MeshShape
    from repro_torch.models.config import ShapeConfig

    t_phase = time.perf_counter()
    cfg = get_smoke_config(DRYRUN_ARCH) if smoke else get_config(DRYRUN_ARCH)
    shape = ShapeConfig("train_8x128", PROMPT, BATCH, "train")
    one = MeshShape(("data", "model"), (1, 1))
    res: dict = {"arch": cfg.name, "tokens": BATCH * PROMPT}

    # (a) starts here: (f)'s cell traced in a process that sees no card,
    # alongside (b)-(f); compared with (f) at the end
    child = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CHILD.format(src=str(ROOT / "src"), root=str(ROOT),
                                                   smoke=smoke)],
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        res.update(_dryrun_checks(cfg, shape, one, device, smoke))
        out, err = child.communicate(timeout=DRYRUN_CHILD_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise AssertionError(f"(a) the trace without a card failed (rc {child.returncode}): "
                             f"{err[-2000:]}")
    other = json.loads(out.strip().splitlines()[-1])
    f_rec = {k: v for k, v in res["f"].items() if k in other["record"]}
    equal = json.loads(json.dumps(f_rec)) == other["record"]
    res["a"] = {"equal": equal, "trace_s": {"with card" if device == "cuda" else "this process":
                                            res["f"]["trace_s"], "no card": other["trace_s"]}}
    print(f"[dryrun] (a) {cfg.name} {res['f']['shape']} on {tuple(res['f']['mesh'])}: the record "
          f"traced in this process {'==' if equal else '!='} the one traced in a process that "
          f"sees no card (CUDA_VISIBLE_DEVICES=''), field for field ({len(f_rec)} keys; traced in "
          f"{res['f']['trace_s']:.2f} s here, {other['trace_s']:.2f} s there)", flush=True)
    if not equal:
        diff = [k for k in f_rec if json.loads(json.dumps(f_rec[k])) != other["record"].get(k)]
        raise AssertionError(f"(a) the record depends on the tracing host: {diff}")
    res["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"dryrun": res}, default=str), flush=True)
    print(f"[dryrun] phase {res['seconds']:.1f} s", flush=True)
    return res


def _dryrun_checks(cfg, shape, one, device: str, smoke: bool) -> dict:
    """(b)-(f) of :func:`dryrun_phase`; returns their entries."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import lm_batch
    from repro_torch.device import synchronize
    from repro_torch.distributed import ep
    from repro_torch.distributed.partitioner import MeshShape
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import run_local_world
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import TrainLoopConfig, make_train_step
    from torch.utils.checkpoint import set_checkpoint_early_stop

    on_card = device == "cuda"
    dev = torch.device(device)
    res = {}
    rec = H.analyze_trace(steps.trace_cell(cfg, shape, one, compute_dtype=False), 1)

    # (b)-(d): the same step for real
    opt_cfg = steps.default_opt_cfg(cfg)
    step_fn = make_train_step(cfg, opt_cfg, TrainLoopConfig(total_steps=10_000, warmup_steps=100))
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = lm.init_params(gen, cfg, device=device).requires_grad_(True)
    opt_state = adamw_init(lm.param_tree(model), opt_cfg)
    batch = lm_batch(cfg, BATCH, PROMPT, seed=SEED, step=0, device=dev)
    step_fn(model, opt_state, batch, 0)  # warm-up: the library handles, the allocator
    synchronize(dev)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    step_fn(model, opt_state, batch, 1)
    synchronize(dev)
    if on_card:
        measured = torch.cuda.max_memory_allocated()
        predicted = rec["memory"]["peak_per_device_bytes"]
        rel = abs(predicted - measured) / measured
        res["c"] = {"predicted_peak": predicted, "measured_peak": measured, "rel": rel,
                    "argument_bytes": rec["memory"]["argument_bytes"], "allocated_before": base}
        print(f"[dryrun] (c) peak memory of one step: predicted {predicted / 2**30:.3f} GiB "
              f"(arguments {rec['memory']['argument_bytes'] / 2**30:.3f}), measured "
              f"{measured / 2**30:.3f} GiB (allocated before the step {base / 2**30:.3f}); "
              f"|diff| {rel:.2%} (bound {DRYRUN_PEAK_TOL:.0%})", flush=True)
        if rel > DRYRUN_PEAK_TOL:
            raise AssertionError(f"(c) predicted peak {predicted} vs measured {measured}: "
                                 f"{rel:.2%} > {DRYRUN_PEAK_TOL:.0%}")
    # under torch.profiler a checkpoint's recomputation does not stop
    # early (it recomputes the layer's last product too), so the step is
    # traced and profiled with early stopping off alike
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with set_checkpoint_early_stop(False):
        rec_b = H.analyze_trace(steps.trace_cell(cfg, shape, one, compute_dtype=False), 1)
        with torch.profiler.profile(activities=acts, with_flops=True) as prof:
            step_fn(model, opt_state, batch, 2)
            synchronize(dev)
    events = prof.key_averages()
    profiled = sum(e.flops for e in events if e.key in PROFILED_PRODUCTS)
    traced = rec_b["flops_per_dev"] + rec_b["row_pad_flops_per_dev"]
    res["b"] = {"traced_flops": rec_b["flops_per_dev"], "traced_row_pad_flops":
                rec_b["row_pad_flops_per_dev"], "profiled_flops": profiled,
                "traced_flops_early_stop": rec["flops_per_dev"]}
    print(f"[dryrun] (b) product FLOPs of one step, recomputation not stopped early: traced "
          f"{traced:.6e} (of them {rec_b['row_pad_flops_per_dev']:.6e} 16-row padding), "
          f"torch.profiler over {'/'.join(k.split('::')[1] for k in PROFILED_PRODUCTS)} "
          f"{profiled:.6e}; with early stopping (the record) {rec['flops_per_dev']:.6e}",
          flush=True)
    if traced != profiled:
        raise AssertionError(f"(b) traced product FLOPs {traced} != profiled {profiled}")
    busy_ms = (sum(e.self_device_time_total for e in events) / 1e3 if on_card else None)
    times = []
    for i in range(3):
        synchronize(dev)
        t0 = time.perf_counter()
        step_fn(model, opt_state, batch, 3 + i)
        synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    r = rec["roofline"]
    res["d"] = {"roofline": r, "step_ms_median": statistics.median(times),
                "device_busy_ms": busy_ms, "bytes_per_dev": rec["bytes_per_dev"],
                "bytes_raw_per_dev": rec["bytes_raw_per_dev"]}
    print(f"[dryrun] (d) roofline (H100 constants) compute {r['compute_s'] * 1e3:.2f} ms, "
          f"memory {r['memory_s'] * 1e3:.2f} ms, collective {r['collective_s'] * 1e3:.2f} ms "
          f"-> {r['dominant']}; measured median step {res['d']['step_ms_median']:.1f} ms, device "
          f"busy {busy_ms if busy_ms is None else round(busy_ms, 1)} ms (profiled step)",
          flush=True)
    del model, opt_state, batch, prof, events
    _fresh_peak(on_card)

    # (e) the EP layer's all-to-all bytes, traced against a real gloo world
    ep_cfg = dataclasses.replace(get_smoke_config(EP_ARCH) if smoke else get_config(EP_ARCH),
                                 n_layers=1, moe_impl="ep_shard_map")
    rows = BATCH // DIST_RANKS
    with steps.fake_world(MeshShape(("model",), (DIST_RANKS,))) as mesh:
        layer, x = _ep_inputs(ep_cfg, DIST_RANKS, rows, "meta")
        an = H.StepAnalysis()
        with H.analysing(an):
            ep.ep_moe_ffn(layer, x, ep_cfg, mesh)
        a2a = an.finish().coll["all-to-all"]
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_local_world(_ep_bytes_rank, DIST_RANKS, workdir=tmp,
                                payload={"device": device, "smoke": smoke, "rows": rows},
                                device=device, backend="gloo", timeout_s=DIST_TIMEOUT_S)
    res["e"] = {"traced_bytes": a2a["operand_bytes"], "traced_calls": a2a["count"],
                "moved_bytes": [r["bytes"] for r in ranks], "calls": [r["calls"] for r in ranks]}
    print(f"[dryrun] (e) EP layer, {ep_cfg.name} full width, {DIST_RANKS} ranks, {rows} x "
          f"{PROMPT} rows each: traced all-to-all {a2a['operand_bytes']} B in {a2a['count']} "
          f"calls per rank, the gloo run moved {res['e']['moved_bytes']} B in "
          f"{res['e']['calls']} calls", flush=True)
    if any(b != a2a["operand_bytes"] for b in res["e"]["moved_bytes"]):
        raise AssertionError(f"(e) traced all-to-all bytes {a2a['operand_bytes']} != moved "
                             f"{res['e']['moved_bytes']}")

    res["f"] = _dryrun_cell(cfg.name, smoke)
    return res


def _dryrun_cell(arch: str, smoke: bool) -> dict:
    """(f): one production cell, whole, traced on the card's host; its
    record printed, a failed trace as the reference's ``status: "error"``
    record, which then fails the phase."""
    t0 = time.perf_counter()
    try:
        cell, _ = _production_record(smoke)
        cell["status"] = "ok"
    except Exception as e:
        cell = {"status": "error", "error": f"{type(e).__name__}: {e}"[:500]}
    cell["trace_s"] = time.perf_counter() - t0
    rec = {"arch": arch, "shape": DRYRUN_CELL, "mesh": list(DRYRUN_MESH), **cell}
    print(f"[dryrun] (f) {arch} {DRYRUN_CELL} on {DRYRUN_MESH}: "
          f"{json.dumps(rec, sort_keys=True)}", flush=True)
    if cell["status"] != "ok":
        raise AssertionError(f"(f) the production cell's trace failed: {cell['error']}")
    return rec


def _production_record(smoke: bool) -> tuple[dict, float]:
    """(f)'s cell traced on this host: ``analyze_trace``'s record and the
    seconds the trace took. (a) runs it again in a process that sees no
    card (``DRYRUN_CHILD``)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.models.config import SHAPES as CELL_SHAPES

    cfg = get_smoke_config(DRYRUN_ARCH) if smoke else get_config(DRYRUN_ARCH)
    mesh = production_mesh_shape(multi_pod=False)
    if tuple(mesh.sizes) != DRYRUN_MESH:
        raise AssertionError(f"the production mesh is {mesh.sizes}, expected {DRYRUN_MESH}")
    t0 = time.perf_counter()
    rec = H.analyze_trace(steps.trace_cell(cfg, CELL_SHAPES[DRYRUN_CELL], mesh), mesh.size)
    return rec, time.perf_counter() - t0


# the decode graph phase: internvl2-1b's lockstep wave (32 images, 64
# steps), qwen3-moe at 1 of 94 layers in 64 slots and tinyllama in 8
# through serve(), mamba2 (8 of 64 layers) and the hybrid's smoke config
# in lockstep
GRAPH_VLM = "internvl2-1b"
GRAPH_VLM_BATCH = 32
GRAPH_WAVE = 64
GRAPH_MOE_LAYERS = 1
GRAPH_MOE_SLOTS = 64
GRAPH_MOE_REQUESTS = 96
GRAPH_SSM_STEPS = 32


class _NoGraphs:
    """A decode-graph backend that never captures: each step eager."""

    def usable(self, device) -> bool:
        return False


def _caches_equal(a: dict, b: dict) -> bool:
    import torch

    return all(torch.equal(t, b[slot][name]) for slot, kv in a.items() for name, t in kv.items())


def _graph_outcomes(tel) -> dict:
    """``model_decode_graph_total`` by outcome (eager by its reason),
    leaving out the eager side's steps (its backend has no graphs)."""
    from repro_torch.compiler import decode_graph

    out = {}
    for key, child in tel.metrics.counter(decode_graph.COUNTER)._series.items():
        labels = dict(key)
        name = labels.get("reason", labels["outcome"])
        if name != "device":
            out[name] = int(child.value)
    return out


def _timed(fn, device) -> tuple:
    """(fn(), host ms, CUDA-event ms) of one call on ``device`` (the
    host's ms on the CPU)."""
    import torch

    from repro_torch.device import synchronize

    on_card = device.type == "cuda"
    synchronize(device)
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    out = fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    if on_card:
        end.record()
    synchronize(device)
    return out, host_ms, start.elapsed_time(end) if on_card else host_ms


def _graph_wave(cm, tokens, steps: int, backend, what: str, extra_embeds=None) -> dict:
    """One lockstep wave twice over, a step of each in turn: through
    ``cm``'s decode graphs and eagerly, the logits and every cache tensor
    ``torch.equal`` at every step; then a wave each way alone, timed
    (CUDA events and the host's clock), whose tokens must be equal."""
    import torch

    from repro_torch import obs
    from repro_torch.compiler import decode_graph

    s = tokens.shape[1] + (0 if extra_embeds is None else extra_embeds.shape[1])
    eager = decode_graph.DecodeGraphs(_NoGraphs())

    def start():
        logits, pre = cm.prefill(tokens, extra_embeds)
        caches = cm.graft_prefill_caches(cm.init_cache(tokens.shape[0], s + steps), pre)
        return torch.argmax(logits, dim=-1), caches

    @torch.no_grad()
    def wave(graphs, tok, caches):
        cm.decode_graphs = graphs
        out = [tok]
        for i in range(steps - 1):
            logits, caches = cm.decode_step(out[-1], s + i, caches)
            out.append(torch.argmax(logits, dim=-1))
        return torch.stack(out, dim=1)

    graphs = decode_graph.DecodeGraphs(backend)
    (tok_g, caches_g), (tok_e, caches_e) = start(), start()
    with obs.session() as tel, torch.no_grad():
        for i in range(steps - 1):
            cm.decode_graphs = graphs
            lg, _ = cm.decode_step(tok_g, s + i, caches_g)
            cm.decode_graphs = eager
            le, _ = cm.decode_step(tok_e, s + i, caches_e)
            if not (torch.equal(lg, le) and _caches_equal(caches_g, caches_e)):
                raise AssertionError(f"{what}: step {i} through the graph != eager")
            tok_g, tok_e = torch.argmax(lg, dim=-1), torch.argmax(le, dim=-1)
    outcomes = _graph_outcomes(tel)
    tok_e, caches_e = start()
    gen_e, host_e, dev_e = _timed(lambda: wave(eager, tok_e, caches_e), cm.device)
    tok_g, caches_g = start()
    gen_g, host_g, dev_g = _timed(lambda: wave(decode_graph.DecodeGraphs(backend), tok_g,
                                               caches_g), cm.device)
    if not torch.equal(gen_g, gen_e):
        raise AssertionError(f"{what}: the graphed wave's tokens != the eager wave's")
    cm.decode_graphs = decode_graph.DecodeGraphs(backend)
    n = steps - 1
    print(f"[decode graph] {what}: {n} steps, logits and caches == eager at every step, the "
          f"wave's tokens equal; outcomes {outcomes}; per step {dev_g / n:.2f} ms graphed "
          f"against {dev_e / n:.2f} ms eager by CUDA events (host {host_g / n:.2f} / "
          f"{host_e / n:.2f} ms)", flush=True)
    return {"outcomes": outcomes, "graph_ms": dev_g / n, "eager_ms": dev_e / n,
            "graph_host_ms": host_g / n, "eager_host_ms": host_e / n}


def _graph_serve(cm, reqs, slots: int, max_len: int, backend, what: str) -> dict:
    """The requests through two serving engines on ``cm`` a tick of each
    in turn, one with decode graphs and one eager: every tick's logits
    and every cache tensor ``torch.equal``, every request's tokens equal;
    then each alone, timed."""
    import torch

    from repro_torch import obs
    from repro_torch.compiler import decode_graph

    eager = decode_graph.DecodeGraphs(_NoGraphs())
    graphs = decode_graph.DecodeGraphs(backend)
    seen = []
    step = cm.decode_step

    def recorded(token, pos, caches):
        logits, caches = step(token, pos, caches)
        seen.append(logits)
        return logits, caches

    engines = {}
    cm.decode_step = recorded
    try:
        with obs.session() as tel:
            for name in ("graph", "eager"):
                se = cm.serve(max_batch=slots, max_len=max_len)
                engines[name] = (se, [se.submit(r) for r in reqs])
            ticks = 0
            while not (engines["graph"][0].idle() and engines["eager"][0].idle()):
                for name, dg in (("graph", graphs), ("eager", eager)):
                    cm.decode_graphs = dg
                    engines[name][0].step()
                if len(seen) == 2 and not torch.equal(*seen):
                    raise AssertionError(f"{what}: tick {ticks} logits through the graph != eager")
                if len(seen) not in (0, 2):
                    raise AssertionError(f"{what}: tick {ticks} decoded in one engine only")
                if not _caches_equal(engines["graph"][0].caches, engines["eager"][0].caches):
                    raise AssertionError(f"{what}: tick {ticks} caches through the graph != eager")
                ticks += bool(seen)
                seen.clear()
    finally:
        del cm.decode_step
    outcomes = _graph_outcomes(tel)
    for st_g, st_e in zip(engines["graph"][1], engines["eager"][1]):
        if not st_g.done or st_g.generated != st_e.generated:
            raise AssertionError(f"{what}: request {st_g.rid} through the graph != eager")
    del engines

    def alone(dg):
        cm.decode_graphs = dg
        se = cm.serve(max_batch=slots, max_len=max_len)
        states = [se.submit(r) for r in reqs]
        se.drain()
        return [tuple(st.generated) for st in states], se.stats().ticks

    (gen_e, ticks_e), host_e, dev_e = _timed(lambda: alone(eager), cm.device)
    (gen_g, ticks_g), host_g, dev_g = _timed(lambda: alone(decode_graph.DecodeGraphs(backend)),
                                             cm.device)
    if gen_g != gen_e:
        raise AssertionError(f"{what}: the graphed run's tokens != the eager run's")
    cm.decode_graphs = decode_graph.DecodeGraphs(backend)
    print(f"[decode graph] {what}: {len(reqs)} requests in {slots} slots, {ticks} ticks, logits "
          f"and caches == eager at every tick, every request's tokens equal; outcomes "
          f"{outcomes}; per tick {dev_g / ticks_g:.2f} ms graphed against {dev_e / ticks_e:.2f} "
          f"ms eager by CUDA events (host {host_g / ticks_g:.2f} / {host_e / ticks_e:.2f} ms; "
          f"prefills included)", flush=True)
    return {"outcomes": outcomes, "ticks": ticks, "graph_ms": dev_g / ticks_g,
            "eager_ms": dev_e / ticks_e}


def decode_graph_phase(device: str = "cuda", smoke: bool = False, backend=None) -> dict:
    """``CompiledModel.decode_step`` as a CUDA graph against eager steps,
    on the ``packed`` engine with seeded random weights:

    (a) internvl2-1b at full depth: a lockstep wave of 32 images (256
        patches and a 32-token text each), 64 steps;
    (b) qwen3-moe-235b-a22b at full width, 1 of 94 layers: 96 requests
        in 64 slots through ``serve()`` (identity and gathered ticks);
    (c) tinyllama-1.1b: 24 requests in 8 slots through ``serve()``;
    (d) mamba2-2.7b at 8 of 64 layers and the hybrid's smoke config
        (jamba-1.5-large-398b): a lockstep wave each.

    Each is held to eager steps bit for bit (``_graph_wave``,
    ``_graph_serve``) and timed both ways; the graphed side's
    ``model_decode_graph_total`` is printed. ``device="cpu", smoke=True``
    with a ``backend`` rehearses it at the smoke configs' size."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import compiler
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import frontend_embeds
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import Request

    t_phase = time.perf_counter()
    on_card = device == "cuda"

    def config(arch, **full):
        return get_smoke_config(arch) if smoke else dataclasses.replace(get_config(arch), **full)

    def compiled(cfg):
        params = lm.init_params(torch.Generator(device=device).manual_seed(SEED), cfg,
                                device=device)
        return compiler.compile(cfg, params, compiler.HardwareTarget(engine="packed"),
                                device=device)

    def requests(cfg, n, lo, hi, gen_lo, gen_hi):
        rng = np.random.default_rng(REQUEST_SEED)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=int(
                    rng.integers(lo, hi + 1))).astype(np.int32),
                        max_new_tokens=int(rng.integers(gen_lo, gen_hi + 1)))
                for i in range(n)]

    res: dict = {}
    _fresh_peak(on_card)
    vlm = config(GRAPH_VLM)
    batch = 4 if smoke else GRAPH_VLM_BATCH
    steps = 8 if smoke else GRAPH_WAVE
    cm = compiled(vlm)
    tokens = torch.as_tensor(serve.prompts(vlm, batch, PROMPT, SEED), device=device)
    extra = frontend_embeds(vlm, batch, generator=torch.Generator().manual_seed(SEED),
                            device=device)
    res["a"] = _graph_wave(cm, tokens, steps, backend,
                           f"(a) {vlm.name} {vlm.n_layers} layers, batch {batch}, "
                           f"{vlm.frontend_len} patches + {PROMPT} text", extra_embeds=extra)
    del cm
    _fresh_peak(on_card)

    moe = config(BREADTH_MOE, n_layers=GRAPH_MOE_LAYERS)
    slots = 4 if smoke else GRAPH_MOE_SLOTS
    n_req = 6 if smoke else GRAPH_MOE_REQUESTS
    cm = compiled(moe)
    res["b"] = _graph_serve(cm, requests(moe, n_req, 16, 128, 8, 40), slots, 192, backend,
                            f"(b) {moe.name} {moe.n_layers} layer(s)")
    del cm
    _fresh_peak(on_card)

    dense = config(ARCH)
    cm = compiled(dense)
    res["c"] = _graph_serve(cm, requests(dense, 24, 8, PROMPT, 4, GEN), BATCH,
                            PROMPT + GEN, backend, f"(c) {dense.name}")
    del cm
    _fresh_peak(on_card)

    for key, arch, full in (("d_ssm", BREADTH_SSM, {"n_layers": BREADTH_SSM_LAYERS}),
                            ("d_hybrid", BREADTH_HYBRID, None)):
        cfg = get_smoke_config(arch) if smoke or full is None else config(arch, **full)
        cm = compiled(cfg)
        tokens = torch.as_tensor(serve.prompts(cfg, BATCH, PROMPT, SEED), device=device)
        res[key] = _graph_wave(cm, tokens, 8 if smoke else GRAPH_SSM_STEPS, backend,
                               f"(d) {cfg.name} {cfg.n_layers} layers "
                               f"({'+'.join(sorted({k.mixer for k in cfg.pattern}))})")
        del cm
        _fresh_peak(on_card)
    print(f"[decode graph] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return res


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


# a phase alone, after the build (no result line)
ALONE = {"--telemetry-only": "telemetry", "--simulators-only": "simulators",
         "--faults-only": "faults", "--train-only": "train",
         "--train-breadth-only": "train breadth", "--breadth-only": "breadth",
         "--frontends-only": "frontends", "--distributed-only": "distributed",
         "--dryrun-only": "dryrun", "--decode-graph-only": "decode graph"}


def main(argv: list[str]) -> int:
    if argv and (len(argv) > 1 or argv[0] not in (*ONLY, *ALONE)):
        print(f"usage: chip_smoke.py [{' | '.join((*ONLY, *ALONE))}]", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # deterministic cuBLAS, which the train phase's bitwise resume needs,
    # is set before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    phase("device")
    card = check_device()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    phase("build")
    build_kernels()
    if argv and argv[0] in ALONE:
        name = ALONE[argv[0]]
        phase(name)
        {"telemetry": telemetry_phase, "simulators": simulators_phase,
         "faults": faults_phase, "train": train_phase, "train breadth": train_breadth_phase,
         "breadth": breadth_phase, "frontends": frontends_phase,
         "distributed": distributed_phase, "dryrun": dryrun_phase,
         "decode graph": decode_graph_phase}[name]()
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
    phase("faults")
    faults_phase()
    phase("train")
    trained = train_phase()["fused_bnn_matmul"]
    launches["fused_bnn_matmul"] += trained
    BY_VARIANT["fused_bnn_matmul"]["b1"] += trained
    phase("train breadth")
    breadth_trained = train_breadth_phase()
    for kname in ("fused_bnn_matmul", "hamming_matmul"):
        launches[kname] += breadth_trained[kname]
        BY_VARIANT[kname]["b1"] += breadth_trained[kname]
    phase("breadth")
    breadth = breadth_phase()
    launches["fused_bnn_matmul"] += breadth["fused_bnn_matmul"]
    BY_VARIANT["fused_bnn_matmul"]["b1"] += breadth["fused_bnn_matmul"]
    launches["flash_attention"] += breadth["flash_attention"]
    BY_VARIANT["flash_attention"]["sm90"] += breadth["flash_attention"]
    phase("frontends")
    frontends = frontends_phase()
    for kname, variant in (("hamming_matmul", "b1"), ("fused_bnn_matmul", "b1"),
                           ("flash_attention", "sm90")):
        launches[kname] += frontends[kname]
        BY_VARIANT[kname][variant] += frontends[kname]
    phase("decode graph")
    decode_graph_phase()
    phase("distributed")
    distributed = distributed_phase()
    launches["fused_bnn_matmul"] += distributed["fused_bnn_matmul"]
    BY_VARIANT["fused_bnn_matmul"]["b1"] += distributed["fused_bnn_matmul"]
    phase("dryrun")
    dryrun_phase()
    summary = kernel_summary(checked, launches) + launch_summary(flash, mma, launches)
    print(f"[chip_smoke] every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
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
