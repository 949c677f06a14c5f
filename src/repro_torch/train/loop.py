"""The training loop (counterpart of ``repro/train/loop.py``).

Fault-tolerance invariants, the reference's (tests/test_torch_train_loop.py):

1. **Resume == never-failed.** All loop state is (params, opt_state,
   step); data is a pure function of (seed, step) (``repro_torch.data``).
   Killing the process anywhere and restarting from the latest
   checkpoint reproduces the exact same parameter trajectory, bit for
   bit. On the card that needs deterministic kernels: the step runs
   under ``torch.use_deterministic_algorithms(True)`` (the backward of
   the embedding gather, the GQA head gather and the loss's
   ``take_along_dim`` otherwise accumulate with atomics in no fixed
   order), with ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts (the
   launcher sets it) and TF32 off for fp32 matmuls (torch's default).
2. **Checkpoints are atomic and async** (``repro_torch.checkpoint``): a
   crash mid-write cannot corrupt the restore point; writes overlap
   compute.
3. **Preemption-safe**: SIGTERM sets a flag; the loop checkpoints at the
   next step boundary and exits cleanly.
4. **Fault injection**: ``fault_hook(step)`` may raise to simulate node
   loss; ``train`` restarts from the latest checkpoint up to
   ``max_restarts`` times. A step whose loss is not finite is skipped
   whole (params, optimizer state and its step count untouched) and
   counted.
5. **Device-agnostic restore**: checkpoints hold host arrays in the
   reference's layout and restore onto whatever device the restarted
   job has.

One loop for every family, as the reference's: ``cfg.is_encdec``
selects ``models/encdec.py``, else ``models/lm.py`` (dense, MoE, Mamba,
hybrid and VLM stacks); each gives ``init_params``, ``loss_fn`` and the
reference's stacked tree (``param_tree``, ``take_grad_tree``,
``load_param_tree_``, ``update_params_``).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable

import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import lm_batch
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptConfig, adamw_begin, adamw_init, cosine_schedule

# the cuBLAS workspace settings under which its GEMMs are deterministic
DETERMINISTIC_CUBLAS = (":4096:8", ":16:8")


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    total_steps: int = 100
    batch_size: int = 8
    seq_len: int = 128
    peak_lr: float = 3e-4
    warmup_steps: int = 10
    checkpoint_every: int = 25  # 0: no checkpoints (no save, no restore)
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    seed: int = 0
    async_checkpoint: bool = True
    max_restarts: int = 2


def family(cfg: ModelConfig):
    """The model module for ``cfg``, as the reference's loop switches
    (its loop.py:59, :128): ``encdec`` for enc-dec configs, else ``lm``."""
    return encdec_lib if cfg.is_encdec else lm_lib


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, loop: TrainLoopConfig, *,
                    host_sync: bool = True):
    """Returns ``step_fn(model, opt_state, batch, step) -> metrics``, which
    updates ``model`` and ``opt_state`` in place (the reference's returns
    new ones). The optimizer works on the reference's stacked tree
    (``param_tree``): each name's per-layer gradients are stacked, the
    global norm is taken over all of them, then each parameter leaf is
    updated as a stack and written back, one leaf at a time
    (``update_params_``). ``host_sync=False`` gives the step a traced
    run takes (``launch.steps.trace_cell``, on tensors that hold no
    data): the update runs unguarded and the metrics stay tensors."""
    fam = family(cfg)

    def step_fn(model, opt_state: dict, batch: dict, step: int) -> dict:
        loss = fam.loss_fn(model, batch, cfg)
        loss.backward()
        lr = cosine_schedule(step, peak_lr=loop.peak_lr, warmup_steps=loop.warmup_steps,
                             total_steps=loop.total_steps)
        grads = fam.take_grad_tree(model)
        if not host_sync:
            fam.update_params_(model, adamw_begin(grads, opt_state, lr, opt_cfg))
            return {"loss": loss.detach(), "lr": lr}
        ok = bool(torch.isfinite(loss))
        if ok:  # NaN guard: a non-finite loss skips the update whole
            fam.update_params_(model, adamw_begin(grads, opt_state, lr, opt_cfg))
        return {"loss": float(loss.detach()), "lr": float(lr), "skipped": int(not ok)}

    return step_fn


class _Preemption:
    """SIGTERM -> checkpoint-and-exit at the next step boundary."""

    def __init__(self):
        self.requested = False
        self._old = None

    def install(self):
        def handler(signum, frame):
            self.requested = True

        try:
            self._old = signal.signal(signal.SIGTERM, handler)
        except ValueError:  # non-main thread
            pass
        return self

    def uninstall(self):
        if self._old is not None:
            signal.signal(signal.SIGTERM, self._old)


def _require_deterministic_cublas(dev: torch.device) -> None:
    if dev.type == "cuda" and os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in DETERMINISTIC_CUBLAS:
        raise RuntimeError(
            "training on CUDA replays bit for bit only with deterministic cuBLAS: set "
            "CUBLAS_WORKSPACE_CONFIG=:4096:8 before CUDA starts (python -m "
            "repro_torch.launch.train does)"
        )


def _init_model(cfg: ModelConfig, seed: int, dev: torch.device):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return family(cfg).init_params(gen, cfg, device=dev).requires_grad_(True)


def _wait(mgr: CheckpointManager | None) -> None:
    if mgr is not None:
        mgr.wait()


@torch.no_grad()
def _copy_tree_(dst: Any, src: Any) -> None:
    tree_lib.map_with_path(lambda path, t: t.copy_(tree_lib.get(src, path)), dst)


def train(
    cfg: ModelConfig,
    loop: TrainLoopConfig,
    opt_cfg: OptConfig | None = None,
    *,
    fault_hook: Callable[[int], None] | None = None,
    log: Callable[[str], None] = print,
    device=None,
) -> dict[str, Any]:
    """Run (or resume) training on ``device`` (default ``cuda``); returns
    a summary with the final model (``params``) and ``opt_state``.

    ``fault_hook(step)`` may raise ``RuntimeError`` to simulate a node
    failure: the loop restarts from the latest checkpoint up to
    ``loop.max_restarts`` times. Besides the reference's keys the summary
    carries each step's wall time (``step_s``, ending in a device
    synchronize), each save's host-blocking time (``save_s``) and each
    restore's (``restore_s``).
    """
    dev = resolve_device(device)
    _require_deterministic_cublas(dev)
    opt_cfg = opt_cfg or OptConfig()
    fam = family(cfg)
    mgr = CheckpointManager(loop.checkpoint_dir, keep=loop.keep) if loop.checkpoint_every else None
    step_fn = make_train_step(cfg, opt_cfg, loop)
    preempt = _Preemption().install()
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)

    restarts = 0
    losses: list[float] = []
    timings: dict[str, list[float]] = {"step_s": [], "save_s": [], "restore_s": []}
    try:
        while True:
            model = opt_state = None  # a failed attempt's state goes first
            try:
                model = _init_model(cfg, loop.seed, dev)
                opt_state = adamw_init(fam.param_tree(model), opt_cfg)
                start = 0
                if mgr is not None and mgr.latest_step() is not None:
                    t0 = time.perf_counter()
                    like = (fam.param_tree(model, device="meta"), opt_state)
                    (params, state), extra = mgr.restore(like, device="cpu")
                    fam.load_param_tree_(model, params)
                    _copy_tree_(opt_state, state)
                    del params, state
                    synchronize(dev)
                    timings["restore_s"].append(time.perf_counter() - t0)
                    start = int(extra["step"]) + 1
                    log(f"[train] resumed from step {start - 1}")

                t0 = time.time()
                for step in range(start, loop.total_steps):
                    if fault_hook is not None:
                        fault_hook(step)
                    batch = lm_batch(cfg, loop.batch_size, loop.seq_len, seed=loop.seed,
                                     step=step, device=dev)
                    ts = time.perf_counter()
                    metrics = step_fn(model, opt_state, batch, step)
                    synchronize(dev)
                    timings["step_s"].append(time.perf_counter() - ts)
                    losses.append(metrics["loss"])
                    boundary = mgr is not None and (step + 1) % loop.checkpoint_every == 0
                    last = preempt.requested or step == loop.total_steps - 1
                    if boundary or (mgr is not None and last):
                        save = mgr.save_async if loop.async_checkpoint else mgr.save
                        ts = time.perf_counter()
                        save(step, (fam.param_tree(model), opt_state), {"step": step})
                        timings["save_s"].append(time.perf_counter() - ts)
                    if preempt.requested:
                        _wait(mgr)
                        log(f"[train] preempted at step {step}; checkpointed")
                        return {"params": model, "opt_state": opt_state, "final_step": step,
                                "losses": losses, "preempted": True, "restarts": restarts,
                                **timings}
                _wait(mgr)
                return {
                    "params": model,
                    "opt_state": opt_state,
                    "final_step": loop.total_steps - 1,
                    "losses": losses,
                    "preempted": False,
                    "restarts": restarts,
                    "steps_per_s": (loop.total_steps - start) / max(time.time() - t0, 1e-9),
                    **timings,
                }
            except RuntimeError as e:  # injected node failure
                restarts += 1
                if restarts > loop.max_restarts:
                    raise
                log(f"[train] fault at restart {restarts}: {e}; resuming from checkpoint")
                _wait(mgr)
    finally:
        preempt.uninstall()
        torch.use_deterministic_algorithms(was_deterministic)
