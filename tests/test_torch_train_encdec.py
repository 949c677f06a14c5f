"""Training the encoder-decoder stack (seamless-m4t's smoke config: 2 + 2
layers, 16 source frames): ``encdec.loss_fn`` and every gradient leaf
against ``jax.value_and_grad(repro.models.encdec.loss_fn)`` run op by op
(tolerances: tests/torch_grad_parity.py), per-layer remat equal to the
plain loop bit for bit, the training encoder's plain STE path whatever
``cfg.bnn_engine`` says, the training loop's resume == never-failed
after a fault and after a SIGTERM (``torch.equal`` on every parameter
and optimizer-state tensor), a checkpoint in the reference's on-disk
format both ways, and the enc-dec training CLI."""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_grad_parity as tp
from repro import checkpoint as jax_checkpoint
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import encdec as jax_encdec
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import encdec_from_jax, encdec_grads_to_jax, encdec_to_jax, tree_to_jax
from repro_torch.launch import train as train_cli
from repro_torch.models import encdec
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.train import TrainLoopConfig, train

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
TGT = 12  # decoder tokens per row, over the config's 16 source frames


def _case(quant: str):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), quant=quant)
    cfg = dataclasses.replace(get_smoke_config(ARCH), quant=quant)
    jparams = jax_encdec.init_params(jax.random.key(0), jcfg)
    model = encdec_from_jax(jax.tree.map(np.asarray, jparams), device="cpu").requires_grad_(True)
    rng = np.random.default_rng(tp.TOKEN_SEED)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (tp.BATCH, TGT)).astype(np.int32),
             "src_embeds": rng.standard_normal(
                 (tp.BATCH, cfg.frontend_len, cfg.d_model)).astype(np.float32)}
    return jcfg, jparams, cfg, model, batch


def _port(model, batch, cfg):
    loss = encdec.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    loss.backward()
    return float(loss.detach()), encdec_grads_to_jax(model)


@pytest.mark.parametrize("quant", ["none", "bnn"])
def test_encdec_loss_and_every_gradient_leaf_match_the_reference(quant):
    """The stacked ``enc_blocks`` / ``dec_blocks`` tree, the untied head
    and both norms, leaf by leaf."""
    jcfg, jparams, cfg, model, batch = _case(quant)
    jloss, jgrads = tp.reference_value_and_grad(jax_encdec.loss_fn, jparams, batch, jcfg)
    loss, grads = _port(model, batch, cfg)
    tp.assert_loss_and_grads_match(loss, grads, jloss, jgrads)
    assert grads["dec_blocks"]["cross_attn"]["k"]["w"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_kv_heads * cfg.hd)


def test_remat_equals_the_plain_loop_and_ignores_the_serving_engine():
    """``cfg.remat`` checkpoints each encoder and decoder layer: loss and
    gradients equal the plain loop's bit for bit. The training encoder
    takes no engine: with ``bnn_engine="packed"`` (whose product has no
    backward) the loss and every gradient are those of ``"reference"``."""
    _, _, cfg, model, batch = _case("bnn")
    loss_r, grads_r = _port(model, batch, cfg)
    for other in (dataclasses.replace(cfg, remat=False),
                  dataclasses.replace(cfg, bnn_engine="packed")):
        loss_o, grads_o = _port(model, batch, other)
        assert loss_o == loss_r
        for a, b in zip(jax.tree.leaves(grads_r), jax.tree.leaves(grads_o), strict=True):
            np.testing.assert_array_equal(a, b)


def test_checkpointed_layers_save_only_their_bf16_input():
    """With remat, no fp32 (B, Ss, d) encoder activation is saved for the
    backward; without it, every encoder layer saves some."""
    _, _, cfg, model, batch = _case("bnn")
    bsd = (tp.BATCH, cfg.frontend_len, cfg.d_model)

    def saved(c):
        shapes = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: shapes.append((t.dtype, tuple(t.shape))) or t, lambda t: t):
            encdec.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, c)
        return shapes

    assert (torch.float32, bsd) not in saved(cfg)
    assert saved(dataclasses.replace(cfg, remat=False)).count(
        (torch.float32, bsd)) >= cfg.n_encoder_layers


def _loop(path, **kw) -> TrainLoopConfig:
    base = dict(total_steps=6, batch_size=2, seq_len=8, checkpoint_every=2,
                checkpoint_dir=str(path), async_checkpoint=False, warmup_steps=2)
    return TrainLoopConfig(**{**base, **kw})


def _state(out) -> list[tuple[str, torch.Tensor]]:
    return [(tree_lib.key(p), t) for p, t in tree_lib.leaves_with_paths(
        (encdec.param_tree(out["params"]), out["opt_state"]))]


def _assert_same_state(a, b):
    for (ka, ta), (kb, tb) in zip(_state(a), _state(b), strict=True):
        assert ka == kb and torch.equal(ta, tb), ka


def test_encdec_loop_resumes_bit_for_bit(tmp_path):
    """A fault at step 3 (one restart from the step-1 checkpoint) and a
    SIGTERM at step 2 (checkpoint, exit, resume): the final parameters
    and optimizer state equal the never-failed run's; with
    ``checkpoint_every=0`` nothing touches the disk and the run is the
    same."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), quant="bnn")
    ref = train(cfg, _loop(tmp_path / "ref", async_checkpoint=True), device="cpu")
    assert np.isfinite(ref["losses"]).all() and ref["final_step"] == 5
    calls = {"n": 0}

    def fault(step):
        calls["n"] += 1
        if step == 3 and calls["n"] <= 4:
            raise RuntimeError("injected node failure")

    out = train(cfg, _loop(tmp_path / "fault"), fault_hook=fault, device="cpu")
    assert out["restarts"] == 1 and out["losses"][3:] == ref["losses"][2:]
    _assert_same_state(out, ref)

    def preempt(step):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    first = train(cfg, _loop(tmp_path / "preempt"), fault_hook=preempt, device="cpu")
    assert first["preempted"] and first["final_step"] == 2
    resumed = train(cfg, _loop(tmp_path / "preempt"), device="cpu")
    assert not resumed["preempted"] and resumed["final_step"] == 5
    _assert_same_state(resumed, ref)
    bare = train(cfg, _loop(tmp_path / "none", checkpoint_every=0), device="cpu")
    assert not (tmp_path / "none").exists() and not bare["save_s"]
    _assert_same_state(bare, ref)


def _state_pair():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_encdec.init_params(jax.random.key(0), jcfg)
    jstate = jax_adamw_init(jparams, JaxOptConfig(factored=True))
    model = encdec_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    state = adamw_init(encdec.param_tree(model), OptConfig(factored=True))
    g = torch.Generator().manual_seed(5)
    for t in tree_lib.leaves(state["m"]):
        t.copy_(torch.randn(t.shape, generator=g))
    state["step"].fill_(4)
    return jparams, jstate, model, state


def test_an_encdec_checkpoint_round_trips_through_the_reference_format(tmp_path):
    """The port's (params, opt_state) restores in the reference's
    manager leaf for leaf, and the reference's in the port's; the tree
    is ``convert.encdec_to_jax``'s."""
    jparams, jstate, model, state = _state_pair()
    np_tree = encdec_to_jax(model)
    assert jax.tree.structure(np_tree) == jax.tree.structure(jax.tree.map(np.asarray, jparams))
    CheckpointManager(str(tmp_path / "port")).save(4, (encdec.param_tree(model), state),
                                                   {"step": 4})
    (p, s), extra = jax_checkpoint.CheckpointManager(str(tmp_path / "port")).restore(
        (jparams, jstate))
    assert extra["step"] == 4 and int(s["step"]) == 4
    for a, b in zip(jax.tree.leaves((p, s)), jax.tree.leaves((np_tree, tree_to_jax(state))),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    jparams = jax.tree.map(lambda x: x * 2, jparams)
    jstate = dict(jstate, step=jnp.asarray(9, jnp.int32))
    jax_checkpoint.CheckpointManager(str(tmp_path / "ref")).save(9, (jparams, jstate),
                                                                 {"step": 9})
    (p, s), _ = CheckpointManager(str(tmp_path / "ref")).restore(
        (encdec.param_tree(model, device="meta"), state), device="cpu")
    encdec.load_param_tree_(model, p)
    assert int(s["step"]) == 9
    for a, b in zip(jax.tree.leaves(encdec_to_jax(model)), jax.tree.leaves(jparams),
                    strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_train_cli_trains_an_encdec_stack(tmp_path, capsys):
    out = train_cli.run(["--arch", ARCH, "--smoke", "--quant", "bnn", "--steps", "2",
                         "--batch", "2", "--seq", "8", "--ckpt", str(tmp_path), "--device",
                         "cpu"])
    assert out["final_step"] == 1 and np.isfinite(out["losses"]).all()
    assert isinstance(out["params"], encdec.EncDec)
    assert "arch=seamless-smoke quant=bnn final_step=1" in capsys.readouterr().out
