"""The port's training loop: the reference's fault-tolerance invariants
(tests/test_train_loop.py) on the port, ``train()`` against the
reference's ``train()`` from the same parameters and tokens, every
architecture's smoke config through the loop, and the launcher.

Resume == never-failed is held with ``torch.equal`` on every parameter
and every optimizer-state tensor. Against the reference the losses of
the first three steps agree within 5e-4 relative: the reference's step
is jitted, and XLA's fusion moves its bf16 residual stream by an ulp
here and there (ROADMAP.md queue 3): its first loss already differs
from its own op-by-op value (which the port equals to 1e-6,
tests/test_torch_train_grad.py) by 7e-5 relative, and the gap grows to
1.5e-4 over three updates.
"""

import dataclasses
import os
import signal

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import lm_batch as jax_lm_batch
from repro.models import lm as jax_lm
from repro.train import TrainLoopConfig as JaxTrainLoopConfig
from repro.train import train as jax_train
from repro_torch import tree as tree_lib
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data import lm_batch
from repro_torch.launch import train as train_cli
from repro_torch.models import encdec, lm
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.train import TrainLoopConfig, make_train_step, train
from repro_torch.train import loop as loop_lib

torch.set_num_threads(1)

CFG = get_smoke_config("tinyllama-1.1b")


def _loop(tmp_path, **kw) -> TrainLoopConfig:
    base = dict(total_steps=8, batch_size=2, seq_len=16, checkpoint_every=3,
                checkpoint_dir=str(tmp_path), async_checkpoint=False, warmup_steps=2)
    base.update(kw)
    return TrainLoopConfig(**base)


def _state(out) -> list[tuple[str, torch.Tensor]]:
    return [(tree_lib.key(p), t) for p, t in tree_lib.leaves_with_paths(
        (lm.param_tree(out["params"]), out["opt_state"]))]


def _assert_same_state(a, b):
    for (ka, ta), (kb, tb) in zip(_state(a), _state(b), strict=True):
        assert ka == kb and torch.equal(ta, tb), ka


def test_loss_decreases(tmp_path):
    out = train(CFG, _loop(tmp_path, total_steps=30, peak_lr=1e-3), device="cpu")
    first = sum(out["losses"][:5]) / 5
    last = sum(out["losses"][-5:]) / 5
    assert last < first, out["losses"]


@pytest.mark.parametrize("async_checkpoint", [False, True], ids=["sync", "async"])
def test_restart_reproduces_exact_trajectory(tmp_path, async_checkpoint):
    """Kill at step 5, restart from the step-2 checkpoint: the final
    parameters and optimizer state equal the uninterrupted run's."""
    quant = dataclasses.replace(CFG, quant="bnn")
    ref = train(quant, _loop(tmp_path / "ref", async_checkpoint=async_checkpoint), device="cpu")
    calls = {"n": 0}

    def fault(step):
        calls["n"] += 1
        if step == 5 and calls["n"] <= 6:  # fail exactly once
            raise RuntimeError("injected node failure")

    out = train(quant, _loop(tmp_path / "faulty", async_checkpoint=async_checkpoint),
                fault_hook=fault, device="cpu")
    assert out["restarts"] == 1 and len(out["restore_s"]) == 1
    assert out["losses"][:5] == ref["losses"][:5] and out["losses"][5:] == ref["losses"][3:]
    _assert_same_state(out, ref)


def test_too_many_faults_raises(tmp_path):
    def always_fail(step):
        raise RuntimeError("flaky node")

    with pytest.raises(RuntimeError, match="flaky node"):
        train(CFG, _loop(tmp_path, max_restarts=1), fault_hook=always_fail, device="cpu")


def test_preemption_checkpoints_and_exits(tmp_path):
    loop = _loop(tmp_path, total_steps=12)
    ref = train(CFG, _loop(tmp_path / "ref", total_steps=12), device="cpu")

    def hook(step):
        if step == 4:  # SIGTERM, as a scheduler sends it; the handler sets the flag
            os.kill(os.getpid(), signal.SIGTERM)

    out = train(CFG, loop, fault_hook=hook, device="cpu")
    assert out["preempted"] is True and out["final_step"] == 4
    # resuming completes the run from the preemption checkpoint
    out2 = train(CFG, loop, device="cpu")
    assert out2["final_step"] == 11 and out2["preempted"] is False
    _assert_same_state(out2, ref)
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL or callable(
        signal.getsignal(signal.SIGTERM))


def test_nan_guard_skips_the_whole_update():
    """A non-finite loss leaves params, moments and the optimizer's step
    count as they were."""
    opt_cfg = OptConfig()
    step_fn = make_train_step(CFG, opt_cfg, TrainLoopConfig(total_steps=4, batch_size=2,
                                                             seq_len=8))
    model = lm.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    model.requires_grad_(True)
    batch = lm_batch(CFG, 2, 8, device="cpu")
    with torch.no_grad():
        model.embed[batch["tokens"][0, 0], 0] = float("nan")
    opt = adamw_init(lm.param_tree(model), opt_cfg)
    before = [t.clone() for t in tree_lib.leaves((lm.param_tree(model), opt))]
    metrics = step_fn(model, opt, batch, 0)
    assert metrics["skipped"] == 1 and not np.isfinite(metrics["loss"])
    after = tree_lib.leaves((lm.param_tree(model), opt))
    assert int(opt["step"]) == 0
    for a, b in zip(before, after, strict=True):
        assert torch.equal(a, b) or (a.isnan() == b.isnan()).all() and torch.equal(
            a.nan_to_num(), b.nan_to_num())
    assert all(p.grad is None for p in model.parameters())


def test_three_steps_match_the_reference_train(tmp_path, monkeypatch):
    """The port's ``train()`` from the reference's initial parameters and
    tokens (both injected), against the reference's ``train()``."""
    jcfg = jax_smoke_config("tinyllama-1.1b")
    kw = dict(total_steps=3, batch_size=2, seq_len=16, checkpoint_every=10, warmup_steps=1,
              peak_lr=1e-3, async_checkpoint=False)
    ref = jax_train(jcfg, JaxTrainLoopConfig(checkpoint_dir=str(tmp_path / "ref"), **kw),
                    log=lambda s: None)
    jparams = jax.tree.map(np.asarray, jax_lm.init_params(jax.random.key(0), jcfg))

    def init(cfg, seed, dev):
        return params_from_jax(jparams, device=dev).requires_grad_(True)

    def batch(cfg, b, s, *, seed, step, device):
        toks = np.array(jax_lm_batch(jcfg, b, s, seed=seed, step=step)["tokens"])
        return {"tokens": torch.from_numpy(toks).to(device)}

    monkeypatch.setattr(loop_lib, "_init_model", init)
    monkeypatch.setattr(loop_lib, "lm_batch", batch)
    out = train(CFG, TrainLoopConfig(checkpoint_dir=str(tmp_path / "port"), **kw),
                log=lambda s: None, device="cpu")
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=5e-4)
    assert out["losses"][0] != out["losses"][2]


def test_launcher_prints_its_line(tmp_path, capsys):
    out = train_cli.run(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--ckpt", str(tmp_path), "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[train] arch=tinyllama-smoke quant=none final_step=2 loss[first->last]=")
    assert "steps/s=" in line and out["final_step"] == 2
    train_cli.run(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "4", "--batch", "2",
                   "--seq", "16", "--ckpt", str(tmp_path), "--device", "cpu", "--quant", "bnn"])
    assert "[train] resumed from step 2" in capsys.readouterr().out


@pytest.mark.parametrize("engine", ["packed", "reference"])
def test_compiled_model_does_not_move_with_training(engine):
    """``compile()`` of a model in training holds detached copies: an
    in-place optimizer step afterwards changes the model, not the
    compiled one (whose embedding, norms and head would otherwise be
    shared, and with the reference engine its latent weights too)."""
    from repro_torch import compiler

    cfg = dataclasses.replace(CFG, quant="bnn")
    loop = TrainLoopConfig(total_steps=4, batch_size=2, seq_len=16, warmup_steps=0)
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    model.requires_grad_(True)
    cm = compiler.compile(cfg, model, compiler.HardwareTarget(engine=engine), device="cpu")
    assert not any(p.requires_grad for p in cm.params.parameters())
    tokens = lm_batch(cfg, 2, 16, seed=1, device="cpu")["tokens"]
    before, _ = cm.prefill(tokens)
    embed = model.embed.detach().clone()
    step_fn = make_train_step(cfg, OptConfig(), loop)
    step_fn(model, adamw_init(lm.param_tree(model), OptConfig()), lm_batch(cfg, 2, 16, device="cpu"), 1)
    assert not torch.equal(model.embed.detach(), embed)
    after, _ = cm.prefill(tokens)
    assert torch.equal(before, after)


def test_weight_cache_misses_after_an_in_place_update():
    """An engine held across an optimizer step must not serve the weights
    it prepared before the step: the cache reads the tensor's version."""
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import model as paper

    cfg = paper.MLPConfig(dims=(64, 48, 32, 10))
    params = paper.init_mlp(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn((8, 64), generator=torch.Generator().manual_seed(1))
    eng = engine_lib.get_engine("packed")
    before = paper.mlp_forward_infer(params, x, cfg, eng)
    with torch.no_grad():
        params["w1"].neg_()
    after = paper.mlp_forward_infer(params, x, cfg, eng)
    assert torch.equal(after, paper.mlp_forward_infer(params, x, cfg, "packed"))
    assert not torch.equal(after, before)


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_every_architecture_trains_through_the_loop(arch, tmp_path):
    """``train()`` picks each config's family (enc-dec or decoder-only)
    and runs it with checkpoints: 3 finite steps on the smoke config,
    the optimizer state in the family's stacked tree."""
    cfg = dataclasses.replace(get_smoke_config(arch), quant="bnn")
    out = train(cfg, _loop(tmp_path, total_steps=3), device="cpu")
    assert out["final_step"] == 2 and np.isfinite(out["losses"]).all()
    fam = loop_lib.family(cfg)
    assert fam is (encdec if cfg.is_encdec else lm)
    assert [p for p, _ in tree_lib.leaves_with_paths(fam.param_tree(out["params"]))] == [
        p for p, _ in tree_lib.leaves_with_paths(out["opt_state"]["m"])]
