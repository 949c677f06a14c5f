"""``compile(cfg, params, target) -> CompiledModel`` (counterpart of
``repro/compiler/pipeline.py``: validate -> resolve -> program).

1. **Validate** the target eagerly (named :class:`TargetError`\\ s) and
   the config (this slice serves attention-only dense stacks).
2. **Resolve** the execution backend from the registry and flip the
   config to ``quant="bnn"`` for non-reference engines.
3. **Program**: the one-time crossbar write (``lm.program_weights``), so
   decode streams only activations.

With a telemetry session active (:mod:`repro_torch.obs`) each stage
records a span on the ``compile`` track, named as the reference's:
``compile.validate``, ``compile.map``, ``compile.resolve`` and
``compile.program`` (ending after the device's programming work) under
the root ``compile``. The map stage itself, ``price()`` and
``describe()`` arrive with the paper-simulator slice; until then
``compile.map`` records no attributes, as the reference's does for a
target without a mapping plan. The returned :class:`CompiledModel` is
what every consumer drives: ``prefill()`` / ``prefill_continue()`` /
``decode_step()`` for batch loops, ``serve()`` for a
continuous-batching ``ServingEngine``.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import obs
from repro_torch.compiler.target import HardwareTarget, TargetError
from repro_torch.core import engine as engine_lib
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import lm as lm_lib
from repro_torch.models.config import require_servable


def resolve_engine(target: HardwareTarget):
    """A target's execution backend (``None`` = the plain ±1 matmul path)."""
    if target.engine in ("", "reference"):
        return None
    kw = {"fused": target.fused} if target.engine == "packed" else {}
    return engine_lib.get_engine(target.engine, target.spec, **kw)


def compile(cfg, params, target: HardwareTarget, *, device=None) -> "CompiledModel":
    """Compile a model onto a hardware target: validate -> resolve ->
    program, on ``device`` (default ``cuda``; ``params`` move there).
    ``params`` is a :class:`repro_torch.models.lm.LM`, or ``None`` for a
    model that only reports its configuration."""
    dev = resolve_device(device)
    with obs.span("compile", track="compile",
                  engine=target.engine, model=getattr(cfg, "name", "?")) as root:
        cm = _compile_staged(cfg, params, target, dev)
        root.set(programmed=cm.programmed, program_s=cm.program_s)
        return cm


def _compile_staged(cfg, params, target: HardwareTarget, dev) -> "CompiledModel":
    with obs.span("compile.validate", track="compile"):
        target = target.validate()
        require_servable(cfg)

    # the map stage arrives with the paper-simulator slice: its span is
    # recorded without attributes, as the reference's is without a plan
    with obs.span("compile.map", track="compile"):
        pass

    with obs.span("compile.resolve", track="compile") as res_span:
        base = resolve_engine(target)
        if base is not None:
            # a hardware backend executes the binarized projections
            cfg = dataclasses.replace(cfg, quant="bnn", bnn_engine=target.engine)
        res_span.set(backend=base.name if base is not None else "none")

    programmed, program_s = 0, 0.0
    if params is not None:
        params = params.to(dev)
        if base is not None and target.prepare_weights:
            with obs.span("compile.program", track="compile") as prog_span:
                t0 = time.perf_counter()
                with torch.no_grad():
                    params, programmed = lm_lib.program_weights(params, cfg, base)
                # the span's fence, and what makes program_s device time
                # with telemetry off too
                synchronize(dev)
                program_s = time.perf_counter() - t0
                prog_span.set(programmed=programmed, program_s=program_s)
    return CompiledModel(
        cfg=cfg, params=params, target=target, engine=base,
        programmed=programmed, program_s=program_s, device=dev,
    )


class CompiledModel:
    """The artifact ``compile()`` returns: model + target, executable.

    * :meth:`prefill` / :meth:`prefill_continue` / :meth:`decode_step` —
      LM entry points with the target's K-grouped executor bound;
    * :meth:`serve` — a bound continuous-batching ``ServingEngine``.

    Tensors live on :attr:`device`. ``decode_step`` writes into the
    caches it is given, in place.
    """

    def __init__(self, *, cfg, params, target, engine, programmed, program_s, device):
        self.cfg = cfg
        self.params = params
        self.target = target
        self.engine = engine          # resolved base backend (None = plain ±1 matmul)
        self.programmed = programmed  # projection instances programmed
        self.program_s = program_s    # programming wall time
        self.device = device
        self._executors: dict[int, engine_lib.GroupedEngine | None] = {}

    def group_size_for(self, batch: int) -> int:
        """The K the BatchPlanner/executor uses for a ``batch``-slot pool
        (explicit target K > engine capability > one group spanning the
        pool)."""
        return engine_lib.resolve_group_size(self.engine, self.target.group_size, batch)

    def executor(self, batch: int):
        """The K-grouped execution adapter for a ``batch``-slot pool
        (``None`` on the plain reference path), one per K."""
        k = self.group_size_for(batch)
        if k not in self._executors:
            self._executors[k] = (
                engine_lib.GroupedEngine(self.engine, k) if self.engine is not None else None
            )
        return self._executors[k]

    def _require_params(self):
        if self.params is None:
            raise TargetError(
                "this model was compiled without params; re-run "
                "compile(cfg, params, target) to execute"
            )

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens).to(device=self.device, dtype=torch.int64)

    @torch.no_grad()
    def prefill(self, tokens):
        """(B, S) tokens -> (last-position logits (B, V), prompt caches)."""
        self._require_params()
        tokens = self._tokens(tokens)
        ex = self.executor(int(tokens.shape[0]))
        return lm_lib.prefill(self.params, tokens, self.cfg, engine=ex)

    @torch.no_grad()
    def prefill_continue(self, tokens, prefix_caches: dict):
        """Suffix tokens (B, S) over prefill-shaped ``prefix_caches`` ->
        (last-position logits, full-prompt caches), bit-identical to
        :meth:`prefill` of the whole prompt (the prefix-graft path)."""
        self._require_params()
        tokens = self._tokens(tokens)
        ex = self.executor(int(tokens.shape[0]))
        return lm_lib.prefill_continue(self.params, tokens, prefix_caches, self.cfg, engine=ex)

    @torch.no_grad()
    def decode_step(self, token, pos, caches):
        """token (B,), pos scalar or (B,), caches -> (logits, caches);
        the caches are updated in place and returned."""
        self._require_params()
        token = self._tokens(token)
        pos = torch.as_tensor(pos).to(device=self.device, dtype=torch.int64)
        ex = self.executor(int(token.shape[0]))
        return lm_lib.decode_step(self.params, token, pos, caches, self.cfg, engine=ex)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return lm_lib.init_cache(self.cfg, batch, max_len, device=self.device)

    @torch.no_grad()
    def graft_prefill_caches(self, caches: dict, pre_caches: dict) -> dict:
        """Copy prefill-sized caches into the time prefix of serving-
        capacity caches from :meth:`init_cache`, in place."""
        for slot, kv in pre_caches.items():
            for name, src in kv.items():
                dst = caches[slot][name]
                dst[:, :, : src.shape[2]] = src.to(dst.dtype)
        return caches

    def serve(self, *, max_batch: int = 4, max_len: int = 256, scheduler=None):
        """A scheduler-fronted continuous-batching ``ServingEngine`` bound
        to this model (``scheduler``: a ``SchedulerConfig``)."""
        self._require_params()
        from repro_torch.serving.engine import ServingEngine  # serving imports compiler

        return ServingEngine(self, max_batch=max_batch, max_len=max_len, scheduler=scheduler)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        eng = self.engine.name if self.engine is not None else "reference"
        return (
            f"<CompiledModel {self.cfg.name} engine={eng} device={self.device} "
            f"programmed={self.programmed}>"
        )
