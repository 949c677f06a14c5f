"""Batched serving driver (counterpart of ``repro/launch/serve.py``):
prefill a batch of prompts, then decode with a fixed-capacity KV cache;
or, with ``--requests N``, drive the request scheduler.

    # on the card (the default device):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --engine packed --batch 8 --prompt-len 128 --gen 32

    # on the CPU, at smoke size, through the kernels' plain versions:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --engine packed --device cpu

    # the crossbar simulators: a plan-placed tile pool, or EinsteinBarrier's WDM
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --device cpu --engine tiled --mapping-policy tacitmap
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --device cpu --engine wdm

    # the scheduler-fronted request path:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --device cpu --engine packed --requests 12 --sched-policy deadline

    # a fleet of 2 replicas behind the prefix-affinity router:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --engine packed --device cpu --requests 12 --replicas 2 --routing prefix

    # the encoder-decoder model (served through cfg.bnn_engine, no
    # compile) and the vision frontend (256 patch embeddings per prompt):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 \\
        --smoke --engine packed --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b \\
        --smoke --engine packed --device cpu

    # traced: compile-stage, prefill and decode-tick spans as a Chrome
    # trace, and the serving metrics as a Prometheus-style snapshot:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --engine packed --device cpu --requests 12 \\
        --trace-out trace.json --metrics-out metrics.txt

Weights are random (``init_params`` from a ``torch.Generator`` seeded by
``--seed`` on the serving device); prompts come from a numpy generator
seeded by ``--seed``, and the request trace's prompt lengths from
``--request-seed`` (default ``--seed``). A frontend's embeddings
(``data.frontend_embeds``: an enc-dec model's source frames, a VLM's
patches) come from a CPU ``torch.Generator`` seeded by ``--seed``. An
enc-dec model is not compiled (``compile()`` takes decoder-only stacks
on hardware targets): it serves the lockstep batch through
``cfg.bnn_engine`` and refuses the decoder-only knobs, as the reference
does. A VLM's lockstep prompts prepend the patches, and decode
positions start after them; its request path serves token prompts.
``--engine tiled`` always executes per a compiled mapping plan
(``--mapping-policy``, default the arch's policy) and prints its
placement and the cost model's pricing
(``CompiledModel.describe()``); a fleet prints ``FleetEngine.price()``.
Those are the cost model's figures for an ePCM/oPCM crossbar, labelled
as modeled. :func:`run` returns the generations and timings for
programs that drive the CLI in-process, and the telemetry session
(``None`` unless ``--trace-out`` or ``--metrics-out`` was given),
already stopped and written out, with the measured-vs-modeled
crosscheck of the request path's traced decode ticks.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.models import encdec


def build_parser() -> argparse.ArgumentParser:
    from repro_torch import compiler as compiler_lib

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--requests", type=int, default=0, metavar="N",
        help="drive the request scheduler with N requests (staggered prompt "
        "lengths, admission control, typed stats) instead of the lockstep "
        "batch loop",
    )
    ap.add_argument(
        "--request-seed", type=int, default=None, metavar="SEED",
        help="seed of the request trace's prompt lengths alone (default --seed)",
    )
    ap.add_argument(
        "--device", default=None,
        help="cuda (the default; an error when no card is present) or cpu",
    )
    compiler_lib.add_target_args(ap)
    compiler_lib.add_scheduler_args(ap)
    compiler_lib.add_fleet_args(ap)
    compiler_lib.add_obs_args(ap)
    return ap


def prompts(cfg, n: int, length: int, seed: int) -> np.ndarray:
    """(n, length) int64 prompt tokens from a numpy generator."""
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(n, length))


class EncDecServing:
    """An enc-dec model behind the interface :func:`lockstep` drives
    (``prefill`` / ``init_cache`` / ``graft_prefill_caches`` /
    ``decode_step``), for one batch of source embeddings (B, Ss, d):
    every call runs ``models.encdec`` on ``cfg.bnn_engine``. ``target``
    is what the CLI was given; nothing is programmed."""

    def __init__(self, model, cfg, src_embeds: torch.Tensor, target, device):
        self.model, self.cfg, self.target, self.device = model, cfg, target, device
        self.src_embeds = src_embeds.to(device)

    @torch.no_grad()
    def prefill(self, tokens, extra_embeds=None):
        if extra_embeds is not None:
            raise ValueError("an enc-dec prompt takes its frontend embeddings as the source")
        tokens = torch.as_tensor(tokens).to(device=self.device, dtype=torch.int64)
        return encdec.prefill(self.model, self.src_embeds, tokens, self.cfg)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return encdec.init_cache(self.cfg, batch, max_len, self.src_embeds.shape[1],
                                 device=self.device)

    @torch.no_grad()
    def graft_prefill_caches(self, caches: dict, pre: dict) -> dict:
        return encdec.graft_prefill_caches(caches, pre)

    @torch.no_grad()
    def decode_step(self, token, pos, caches):
        return encdec.decode_step(self.model, token, pos, caches, self.cfg)


@torch.no_grad()
def lockstep(compiled, tokens: np.ndarray, gen: int, extra_embeds=None) -> dict:
    """Prefill the batch (after ``extra_embeds`` (B, L, d), a VLM's
    patches, when given), then ``gen - 1`` lockstep decode ticks from
    position ``L + S``. Returns the generated tokens (B, gen), the
    prefill logits and the prefill/decode wall times, each ending in a
    device synchronization."""
    from repro_torch.device import synchronize

    dev = compiled.device
    b, s = tokens.shape
    if extra_embeds is not None:
        s += extra_embeds.shape[1]
    synchronize(dev)
    t0 = time.perf_counter()
    logits, pre = compiled.prefill(tokens, extra_embeds)
    caches = compiled.graft_prefill_caches(compiled.init_cache(b, s + gen), pre)
    synchronize(dev)
    t_prefill = time.perf_counter() - t0

    prefill_logits = logits.cpu()
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = compiled.decode_step(tok, s + i, caches)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    synchronize(dev)
    t_decode = time.perf_counter() - t0
    return {
        "generated": torch.stack(out, dim=1).cpu().numpy(),
        "prefill_logits": prefill_logits,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_s": (gen - 1) * b / max(t_decode, 1e-9),
    }


def serve_requests(compiled, args) -> dict:
    """The scheduler-fronted path: ``args.requests`` requests with
    staggered prompt lengths through ``submit``/``drain``."""
    from repro_torch import compiler as compiler_lib
    from repro_torch.device import synchronize
    from repro_torch.serving import Request

    max_len = args.prompt_len + args.gen
    se = compiled.serve(
        max_batch=args.batch, max_len=max_len,
        scheduler=compiler_lib.scheduler_from_args(args),
    )
    tokens = prompts(compiled.cfg, args.requests, args.prompt_len, args.seed)
    trace_seed = args.request_seed if args.request_seed is not None else args.seed
    rng = np.random.default_rng(trace_seed)
    states = []
    synchronize(compiled.device)
    t0 = time.perf_counter()
    for i in range(args.requests):
        plen = int(rng.integers(max(1, args.prompt_len // 2), args.prompt_len + 1))
        states.append(se.submit(Request(
            rid=i, prompt=tokens[i, :plen].astype(np.int32), max_new_tokens=args.gen,
        )))
    se.drain()
    synchronize(compiled.device)
    wall = time.perf_counter() - t0
    return {"states": states, "stats": se.stats(), "wall_s": wall, "group_k": se.group_k,
            "serving": se}


def serve_fleet(cfg, params, target, args, device) -> dict:
    """The fleet path (``--replicas > 1``): N identically-compiled
    replicas behind the prefix-affinity router, driven by the same
    staggered request trace as :func:`serve_requests`, one arrival per
    fleet tick so the prefix library is live for later arrivals."""
    from repro_torch import compiler as compiler_lib
    from repro_torch.device import synchronize
    from repro_torch.fleet import FleetEngine
    from repro_torch.serving import Request

    fleet = FleetEngine.build(
        cfg, params, target,
        n_replicas=args.replicas,
        max_batch=args.batch,
        max_len=args.prompt_len + args.gen,
        scheduler=compiler_lib.scheduler_from_args(args),
        routing=args.routing,
        block_size=args.prefix_block,
        device=device,
    )
    tokens = prompts(cfg, args.requests, args.prompt_len, args.seed)
    trace_seed = args.request_seed if args.request_seed is not None else args.seed
    rng = np.random.default_rng(trace_seed)
    states = []
    synchronize(device)
    t0 = time.perf_counter()
    for i in range(args.requests):
        plen = int(rng.integers(max(1, args.prompt_len // 2), args.prompt_len + 1))
        states.append(fleet.submit(Request(
            rid=i, prompt=tokens[i, :plen].astype(np.int32), max_new_tokens=args.gen,
        )))
        fleet.step()
    fleet.drain()
    synchronize(device)
    wall = time.perf_counter() - t0
    return {"fleet": fleet, "states": states, "stats": fleet.stats(), "wall_s": wall}


def run(argv: list[str] | None = None) -> dict:
    """Parse ``argv``, build and compile the model, serve, and return the
    results (the CLI prints them). With ``--trace-out`` / ``--metrics-out``
    a telemetry session covers compile and serving; it is stopped and
    its artifacts written before this returns."""
    from repro_torch import compiler as compiler_lib
    from repro_torch import obs
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device

    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        target = compiler_lib.target_from_args(args)
    except compiler_lib.TargetError as e:
        ap.error(str(e))
    if target.engine == "reference" and target.group_size:
        ap.error("--group-size requires a non-reference --engine")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encdec:
        # the compiler pipeline covers the decoder-only LM projection
        # stack; enc-dec archs bind the backend via cfg.bnn_engine and
        # reject the decoder-only-serving knobs (the reference's messages)
        if target.group_size:
            ap.error("--group-size applies to the decoder-only serving path")
        if target.wants_plan:
            ap.error("--mapping-policy/--tile-budget place weights for the "
                     "decoder-only LM projection stack")
        if not target.prepare_weights:
            ap.error("--raw-weights toggles the decoder-only compile "
                     "pipeline's programming phase; the enc-dec path never "
                     "programs weights")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.replicas > 1:
        if cfg.is_encdec:
            ap.error("--replicas drives the decoder-only fleet path")
        if not args.requests:
            ap.error("--replicas > 1 serves the request path; pass --requests N")
    if args.requests and cfg.is_encdec:
        ap.error("--requests drives the decoder-only scheduler path")
    dev = resolve_device(args.device)
    # live before compile() so the pipeline-stage spans are captured
    tel = compiler_lib.obs_from_args(args)
    try:
        result = _serve(args, cfg, target, dev)
    finally:
        if tel is not None:
            obs.stop()
    se = result.pop("serving", None)  # the request path's engine
    if tel is not None:
        tel.write(trace_out=args.trace_out, metrics_out=args.metrics_out)
        if se is not None and tel.tracer.spans("decode_tick"):
            result["crosscheck"] = obs.crosscheck_serving(se, tracer=tel.tracer)
    result["telemetry"] = tel
    return result


def _serve(args, cfg, target, dev) -> dict:
    """The body of :func:`run`: seeded weights, compile (or a fleet of
    compiled replicas), then the lockstep batch or the request trace; an
    enc-dec model serves the lockstep batch uncompiled."""
    from repro_torch import compiler as compiler_lib
    from repro_torch.data import frontend_embeds
    from repro_torch.models import lm as lm_lib

    if target.engine == "tiled" and target.mapping_policy is None:
        # `--engine tiled` executes per an explicit compiled plan; the
        # policy falls back to the arch config's default
        target = dataclasses.replace(target, mapping_policy=cfg.mapping_policy)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    embeds = None
    if cfg.frontend != "none":
        embeds = frontend_embeds(cfg, args.batch,
                                 generator=torch.Generator().manual_seed(args.seed), device=dev)
    if cfg.is_encdec:
        if target.engine != "reference":
            cfg = dataclasses.replace(cfg, quant="bnn", bnn_engine=target.engine)
        model = EncDecServing(encdec.init_params(gen, cfg, device=dev), cfg, embeds, target, dev)
        tokens = prompts(cfg, args.batch, args.prompt_len, args.seed)
        return {"compiled": model, "args": args, **lockstep(model, tokens, args.gen)}
    params = lm_lib.init_params(gen, cfg, device=dev)
    if args.replicas > 1:
        # each replica compiles and programs its own copy of the target
        res = serve_fleet(cfg, params, target, args, dev)
        return {"compiled": res["fleet"].replicas[0].compiled, "args": args, **res}
    compiled = compiler_lib.compile(cfg, params, target, device=dev)
    del params
    result = {"compiled": compiled, "args": args}
    if args.requests:
        result.update(serve_requests(compiled, args))
    else:
        tokens = prompts(compiled.cfg, args.batch, args.prompt_len, args.seed)
        result.update(lockstep(compiled, tokens, args.gen, embeds))
    return result


def main(argv: list[str] | None = None) -> int:
    res = run(argv)
    compiled, args = res["compiled"], res["args"]
    cfg = compiled.cfg
    if cfg.is_encdec:
        # not compiled: every projection runs on cfg.bnn_engine
        if compiled.target.engine != "reference":
            from repro_torch.core import engine as engine_lib

            eng = engine_lib.get_engine(compiled.target.engine)
            print(f"[serve] engine={eng.name} ({eng.info.description})")
        print(f"[serve] arch={cfg.name} device={compiled.device} "
              f"engine={compiled.target.engine} quant={cfg.quant} (enc-dec: not compiled)")
    else:
        print(f"[serve] arch={cfg.name} device={compiled.device} engine={compiled.target.engine} "
              f"quant={cfg.quant} programmed={compiled.programmed} "
              f"({compiled.program_s * 1e3:.1f} ms)")
    if not cfg.is_encdec and compiled.plan is not None and args.replicas == 1:
        print("[serve] placement and the cost model's pricing (modeled for the target's "
              "crossbar, not measured):")
        print(compiled.describe())
    if args.replicas > 1:
        s = res["stats"]
        toks = sum(len(st.generated) for st in res["states"])
        print(f"[fleet] {s.n_replicas} replica(s) x {args.batch} slot(s), "
              f"routing={s.routing} (block={args.prefix_block})")
        print(f"[fleet] drained {args.requests} request(s) in {res['wall_s'] * 1e3:.1f} ms "
              f"({toks / max(res['wall_s'], 1e-9):.1f} tok/s): finished={s.finished} "
              f"rejected={s.rejected} expired={s.expired} failed={s.failed}")
        print(f"[fleet] prefix hits={s.prefix_hits} (rate {s.prefix_hit_rate:.0%}), "
              f"grafted={s.grafted_tokens} prefilled={s.prefill_tokens} prompt tokens; "
              f"failovers={s.failovers} (salvaged={s.salvaged}), "
              f"healthy={s.healthy_replicas}/{s.n_replicas}")
        per = ", ".join(f"r{i}: {r.ticks}t/{r.decoded}d" for i, r in enumerate(s.replicas))
        print(f"[fleet] per-replica ticks/decoded: {per}")
        print(f"[fleet] modeled for the target's crossbar: "
              f"{res['fleet'].price(n_active=args.batch).summary()}")
        done = [st for st in res["states"] if st.done]
        if done:
            print(f"[fleet] rid={done[0].rid} replica={done[0].replica} "
                  f"generated[:8] = {done[0].generated[:8]}")
    elif args.requests:
        st, sch = res["stats"], res["stats"].scheduler
        toks = sum(len(s.generated) for s in res["states"])
        print(f"[serve] scheduler: policy={sch.policy} admission={sch.admission} "
              f"K={res['group_k']} pool={args.batch}x{args.prompt_len + args.gen}")
        print(f"[serve] drained {args.requests} request(s) in {res['wall_s'] * 1e3:.1f} ms "
              f"({toks / max(res['wall_s'], 1e-9):.1f} tok/s): finished={sch.finished} "
              f"rejected={sch.rejected} expired={sch.expired} "
              f"preempted={sch.preempted} resumed={sch.resumed}")
        print(f"[serve] ticks={st.ticks} decoded={st.decoded} mmm_groups={st.mmm_groups} "
              f"pad_lanes={st.pad_lanes} prefills={st.prefills} evictions={st.evictions}")
        done = [s for s in res["states"] if s.done]
        if done:
            print(f"[serve] rid={done[0].rid} generated[:8] = {done[0].generated[:8]}")
    else:
        frontend = {"none": "", "vision": f" after {cfg.frontend_len} patch embeddings"}.get(
            cfg.frontend, f" over {cfg.frontend_len} source frames")
        print(f"[serve] batch={args.batch} prompt={args.prompt_len}{frontend}: prefill "
              f"{res['prefill_s'] * 1e3:.1f} ms; decode {args.gen - 1} steps "
              f"{res['decode_s'] * 1e3:.1f} ms ({res['decode_tok_s']:.1f} tok/s)")
        print(f"[serve] generated[0,:8] = {res['generated'][0, :8].tolist()}")
    if "crosscheck" in res:
        from repro_torch import obs

        print("[obs] measured-vs-modeled decode-tick pricing:")
        print(obs.format_report(res["crosscheck"]))
    if args.trace_out:
        print(f"[obs] wrote Chrome trace (chrome://tracing / Perfetto) -> {args.trace_out}")
    if args.metrics_out:
        print(f"[obs] wrote Prometheus-style metrics snapshot -> {args.metrics_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
