"""The measured loops, one per kind of traffic (the mix's ``loop``):

* ``closed``: requests through the system's scheduler path,
  ``CompiledModel.serve(...)`` -> ``ServingEngine.submit`` / ``step``,
  with ``clients`` requests in flight, each client sending its next
  when the last finishes.
* ``waves``: lockstep batches through ``CompiledModel.prefill(tokens,
  extra_embeds)``, ``init_cache``, ``graft_prefill_caches`` and
  ``decode_step``, as the system's lockstep driver runs them.

Each driver warms up the shapes its traffic uses (set-up), then
``run(seconds, tracer)`` measures: all the work and all the time of the
window. ``tracer.after_step(now)`` runs between steps (the traced run's
profiler window). The serving loop's ``sequences()`` and the waves'
``capture()`` hand the check what was served.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench import counts
from bench.traffic import Stream, Traffic
from bench.weights import draw_normal

# input streams of the warm-up waves, apart from the measured waves'
WARMUP_WAVE = 1_000_000


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeDriver:
    """The scheduler path (the ``closed`` loop)."""

    def __init__(self, compiled, traffic: dict, seed: int, sz: dict):
        from repro_torch.serving import SchedulerConfig

        self.p = traffic
        self.sz = sz
        self.seed = seed
        self.device = compiled.device
        self.se = compiled.serve(
            max_batch=traffic["slots"], max_len=traffic["max_len"],
            scheduler=SchedulerConfig(policy=traffic["policy"], admission=traffic["admission"]),
        )
        self.gen = Traffic(traffic, seed, sz["vocab_size"])
        self.records: dict[int, dict] = {}

    # -- requests --------------------------------------------------------

    def _submit(self, client: int):
        from repro_torch.serving import Request

        rid, plen, out = self.gen.next_request()
        prompt = self.gen.tokens(rid, plen)
        rec = {"prompt": prompt, "times": [], "tokens": [], "client": client}
        self.records[rid] = rec

        def on_token(_rid, token, _index, rec=rec):
            rec["times"].append(time.perf_counter())
            rec["tokens"].append(int(token))

        rec["state"] = self.se.submit(Request(rid=rid, prompt=prompt, max_new_tokens=out,
                                              on_token=on_token))

    @torch.no_grad()
    def warmup(self) -> None:
        """Prefills at the mix's prompt lengths from least to most, ticks
        with every lane busy (the pool's identity plan) and with some
        idle (the gathered plan)."""
        from repro_torch.serving import Request

        lo, hi = self._bounds(self.p["prompt"])
        n = self.p["slots"]
        lengths = np.linspace(lo, hi, n).round().astype(int)
        rng = np.random.default_rng([self.seed, 6])
        for i, plen in enumerate(lengths):
            prompt = rng.integers(0, self.sz["vocab_size"], int(plen)).astype(np.int32)
            self.se.submit(Request(rid=-1 - i, prompt=prompt, max_new_tokens=3 + (i % 2)))
        self.se.drain()
        _sync(self.device)

    @staticmethod
    def _bounds(dist: dict) -> tuple[int, int]:
        if dist["dist"] == "fixed":
            return int(dist["value"]), int(dist["value"])
        return int(dist["min"]), int(dist["max"])

    # -- the window ------------------------------------------------------

    @torch.no_grad()
    def run(self, seconds: float, tracer) -> dict:
        t0 = time.perf_counter()
        end = t0 + seconds
        tracer.begin(t0, end)
        for c in range(self.p["clients"]):
            self._submit(c)
        now = t0
        while now < end:
            done = self.se.step()
            now = time.perf_counter()
            tracer.after_step(now)
            for st in done:
                if now < end:
                    self._submit(self.records[st.rid]["client"])
        tracer.end(now)
        return self._summary(t0, now)

    def _summary(self, t0: float, t_end: float) -> dict:
        """Tokens and model FLOPs of the window; a request with no token
        yet is still in flight."""
        from repro_torch.serving.scheduler import RequestStatus

        tokens, flops, attempted, failed = 0, 0.0, 0, 0
        for r in self.records.values():
            attempted += 1
            if r["state"].status in (RequestStatus.REJECTED, RequestStatus.EXPIRED,
                                     RequestStatus.FAILED):
                failed += 1
                continue
            plen = len(r["prompt"])
            for j, t in enumerate(r["times"]):
                if t > t_end:
                    break
                tokens += 1
                flops += (counts.prefill_flops(self.sz, plen) if j == 0
                          else counts.decode_flops(self.sz, plen + j))
        return {"t0": t0, "seconds": t_end - t0, "tokens": tokens, "flops": flops,
                "attempted": attempted, "failed": failed}

    def sequences(self) -> list[dict]:
        from repro_torch.serving.scheduler import RequestStatus

        out = []
        for r in self.records.values():
            if r["state"].status is RequestStatus.FINISHED:
                plen = len(r["prompt"])
                out.append({"tokens": r["prompt"], "extra": None, "generated": r["tokens"],
                            "routed_calls": [(0, plen)] + [(plen + j, plen + j + 1)
                                                           for j in range(len(r["tokens"]) - 1)]})
        return out

    def release(self) -> None:
        self.se = None


class WaveDriver:
    """Lockstep waves of ``batch`` sequences: ``extra`` prepended
    embeddings (the config's ``frontend_len``) and a text prompt each,
    then ``output`` tokens, all greedy."""

    def __init__(self, compiled, traffic: dict, seed: int, sz: dict, extra_std: float):
        self.cm = compiled
        self.p = traffic
        self.sz = sz
        self.seed = seed
        self.device = compiled.device
        self.b = traffic["batch"]
        self.extra_len = sz["frontend_len"]
        self.gen_len = int(traffic["output"]["value"])
        self.extra_std = extra_std
        lengths = Stream(traffic["prompt"], seed, 1, int(traffic.get("block", 16)))
        self.inputs = [self._inputs(w, int(s)) for w, s in
                       enumerate(lengths.take(int(traffic["waves_ready"])))]
        self.waves: list[dict] = []

    def _inputs(self, wave: int, text_len: int) -> dict:
        rng = np.random.default_rng([self.seed, 7, wave])
        tokens = rng.integers(0, self.sz["vocab_size"], size=(self.b, text_len), dtype=np.int64)
        extra = draw_normal((self.b, self.extra_len, self.sz["d_model"]), self.seed, 100 + wave,
                            self.extra_std, self.device, torch.bfloat16)
        return {"tokens": torch.as_tensor(tokens, device=self.device), "extra": extra}

    @torch.no_grad()
    def _wave(self, inp: dict, gen: int, end: float | None, tracer=None) -> dict:
        """Prefill, then up to ``gen - 1`` decode steps (fewer when the
        window closes at ``end``), into caches sized for the mix's whole
        output either way."""
        s = self.extra_len + inp["tokens"].shape[1]
        _sync(self.device)
        t0 = time.perf_counter()
        logits, pre = self.cm.prefill(inp["tokens"], inp["extra"])
        caches = self.cm.graft_prefill_caches(self.cm.init_cache(self.b, s + self.gen_len), pre)
        tok = torch.argmax(logits, dim=-1)
        _sync(self.device)
        prefill_s = time.perf_counter() - t0
        out = [tok]
        for i in range(gen - 1):
            if end is not None:
                now = time.perf_counter()
                if tracer is not None:
                    tracer.after_step(now)
                if now >= end:
                    break
            logits, caches = self.cm.decode_step(tok, s + i, caches)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        generated = torch.stack(out, dim=1).cpu().numpy()
        decode_s = time.perf_counter() - t0 - prefill_s
        return {"prefill_s": prefill_s, "decode_s": decode_s, "generated": generated, "len": s}

    def warmup(self) -> None:
        """One short wave at the longest and one at the shortest text."""
        lo, hi = int(self.p["prompt"]["min"]), int(self.p["prompt"]["max"])
        for w, n in ((WARMUP_WAVE, hi), (WARMUP_WAVE + 1, lo)):
            self._wave(self._inputs(w, n), 3, None)
        _sync(self.device)

    def run(self, seconds: float, tracer) -> dict:
        t0 = time.perf_counter()
        end = t0 + seconds
        tracer.begin(t0, end)
        tokens, flops, w = 0, 0.0, 0
        now = t0
        while now < end:
            inp = self.inputs[w % len(self.inputs)]
            wave = self._wave(inp, self.gen_len, end, tracer)
            now = time.perf_counter()
            tracer.after_step(now)
            wave["input"] = w % len(self.inputs)
            self.waves.append(wave)
            n_gen = wave["generated"].shape[1]
            tokens += self.b * n_gen
            flops += self.b * counts.prefill_flops(self.sz, wave["len"])
            flops += self.b * sum(counts.decode_flops(self.sz, wave["len"] + i + 1)
                                  for i in range(n_gen - 1))
            w += 1
        tracer.end(now)
        return {"t0": t0, "seconds": now - t0, "tokens": tokens, "flops": flops,
                "attempted": self.b * len(self.waves), "failed": 0,
                "prefill_s": [wv["prefill_s"] for wv in self.waves],
                "decode_step_s": [wv["decode_s"] / (wv["generated"].shape[1] - 1)
                                  for wv in self.waves if wv["generated"].shape[1] > 1]}

    @torch.no_grad()
    def capture(self, n_images: int) -> dict:
        """Replay the window's wave with the longest sequences (the most
        tokens served, then the longest text) through the same entry points, recording each layer's residual stream after
        attention (``R``) and after the FFN (``H``) for ``n_images``
        images drawn from the seed: the system's own state, layer by
        layer, for a check that follows it. ``mismatch`` counts served
        tokens of the wave that the replay does not give again."""
        from repro_torch.models import lm as lm_lib

        # the longest sequences served: the most tokens, then the longest text
        wave = max(self.waves, key=lambda wv: (wv["generated"].shape[1], wv["len"]))
        inp = self.inputs[wave["input"]]
        rng = np.random.default_rng([self.seed, 8])
        idx = sorted(rng.choice(self.b, size=min(n_images, self.b), replace=False).tolist())
        sel = torch.as_tensor(idx, device=self.device)
        rs, hs = [], []
        orig = lm_lib._ffn_residual

        def recorded(blk, h, cfg, eng):
            out = orig(blk, h, cfg, eng)
            rs.append(h.index_select(0, sel).clone())
            hs.append(out[0].index_select(0, sel).clone())
            return out

        lm_lib._ffn_residual = recorded
        try:
            replay = self._wave(inp, wave["generated"].shape[1], None)
        finally:
            lm_lib._ffn_residual = orig
        nl = self.sz["n_layers"]
        calls = len(rs) // nl
        return {
            "tokens": inp["tokens"][sel].cpu().numpy(), "extra": inp["extra"][sel],
            "generated": wave["generated"][idx],
            "R": [torch.cat([rs[c * nl + i] for c in range(calls)], dim=1) for i in range(nl)],
            "H": [torch.cat([hs[c * nl + i] for c in range(calls)], dim=1) for i in range(nl)],
            "mismatch": int((replay["generated"] != wave["generated"]).sum()),
        }

    def release(self) -> None:
        self.cm = None


def make_driver(compiled, cell, seed: int, sz: dict):
    loop = cell.traffic["loop"]
    if loop == "closed":
        return ServeDriver(compiled, cell.traffic, seed, sz)
    if loop == "waves":
        return WaveDriver(compiled, cell.traffic, seed, sz, cell.config["weights"]["extra_std"])
    raise ValueError(f"unknown loop {loop!r}")
