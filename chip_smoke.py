#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (device 0), the CUDA toolkit's ``nvcc`` and
``nvidia-smi``; exits non-zero without them. Phases, each announced on
its own ``[phase]`` line:

1. device: card name and power limit, TF32 off for fp32 matmuls;
2. build: both CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version at the
   tinyllama-1.1b projection shapes (bit-exact, ``torch.equal``), with
   kernel, plain-version and one-PyTorch-call times and the card's bound;
4. serve: tinyllama-1.1b at full width (random weights from a seeded
   generator) through ``repro_torch.launch.serve``: a lockstep batch on
   the ``packed`` engine, the same batch under ``--raw-weights`` and on
   the ``reference`` engine (tokens must match), and the request
   scheduler path. The kernels' launch counts are read around each run,
   and a few decode ticks run under ``torch.profiler`` to show where a
   tick's time goes.

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
# per SM on compute capability 9.0)
HBM_BYTES_PER_S = 3.35e12
POPC_PER_CLOCK_PER_SM = 16

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


# ---------------------------------------------------------------------------
# phase 4: serve tinyllama-1.1b at full width
# ---------------------------------------------------------------------------

ARCH = "tinyllama-1.1b"
BATCH, PROMPT, GEN, REQUESTS = 8, 128, 32, 16


def _reset_counts() -> None:
    from repro_torch.kernels import fused_decode, xnor_matmul

    fused_decode.launches = 0
    xnor_matmul.launches = 0


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


def main() -> int:
    phase("device")
    card, clock_mhz = check_device()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    phase("build")
    build_kernels()
    phase("kernels")
    checked = check_kernels(clock_mhz)
    phase("serve")
    launches = serve_phase()
    print(json.dumps({"kernels": kernel_summary(checked, launches)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
