"""Training breadth, the MoE stacks: the port's ``lm.loss_fn`` and every
gradient leaf against ``jax.value_and_grad`` of the JAX package's, run
op by op, on the qwen3-moe smoke config (quant none and bnn), with
capacity drops forced, and the MoE training CLI. Tolerances:
tests/torch_grad_parity.py (loss 1e-6 relative, leaves 2e-2 of their
largest magnitude: the experts run in bf16).

The other families have files of their own, each short enough to keep
``--dist loadfile`` balanced: grok-1 (tests/test_torch_train_grok.py),
Mamba-2 (tests/test_torch_train_ssm.py), the hybrid jamba
(tests/test_torch_train_jamba.py) and its step-0 finding
(tests/test_torch_train_jamba_step0.py), the VLM
(tests/test_torch_train_vlm.py) and the enc-dec stack
(tests/test_torch_train_encdec.py).
"""

import numpy as np
import pytest
import torch

import torch_grad_parity as tp
from repro.models import lm as jax_lm
from repro_torch.launch import train as train_cli
from repro_torch.models import moe

torch.set_num_threads(1)

ARCH = "qwen3-moe-235b-a22b"


@pytest.mark.parametrize("quant", ["none", "bnn"])
def test_moe_loss_and_every_gradient_leaf_match_the_reference(quant):
    """The router, the expert stacks (L, E, d, f), the attention and the
    aux loss's share, against the reference's tree leaf by leaf."""
    jcfg, jparams, cfg, model, batch = tp.lm_case(ARCH, quant)
    jloss, jgrads = tp.reference_value_and_grad(jax_lm.loss_fn, jparams, batch, jcfg)
    loss, grads = tp.port_lm_value_and_grad(model, batch, cfg)
    tp.assert_loss_and_grads_match(loss, grads, jloss, jgrads)
    assert grads["blocks"]["slot0"]["moe"]["w1"].shape == (
        cfg.n_repeats, cfg.moe_experts, cfg.d_model, cfg.d_ff)


def test_moe_gradients_match_with_capacity_drops(monkeypatch):
    """Capacity factor 0.5: each row's 64 assignments over 8 experts
    meet a capacity of 4, so assignments are dropped (``keep`` false in
    every MoE layer of the batch, asserted). A dropped assignment
    dispatches into the spare slot C and combines from the clamped last
    slot times zero, where the reference scatter-adds with ``mode="drop"``
    and gathers out of range; values and gradients agree."""
    jcfg, jparams, cfg, model, batch = tp.lm_case(ARCH, "bnn", moe_capacity_factor=0.5)
    kept = []
    slots = moe.slots

    def recording(top_idx, n_experts, cap):
        out = slots(top_idx, n_experts, cap)
        kept.append(out[2])
        return out

    monkeypatch.setattr(moe, "slots", recording)
    jloss, jgrads = tp.reference_value_and_grad(jax_lm.loss_fn, jparams, batch, jcfg)
    loss, grads = tp.port_lm_value_and_grad(model, batch, cfg)
    assert moe.capacity(cfg, tp.SEQ) == 4
    assert len(kept) >= cfg.n_layers and all(not bool(k.all()) for k in kept)
    tp.assert_loss_and_grads_match(loss, grads, jloss, jgrads)


def test_train_cli_trains_and_resumes_a_moe_stack(tmp_path, capsys):
    def argv(steps):
        return ["--arch", ARCH, "--smoke", "--quant", "bnn", "--steps", str(steps), "--batch",
                "2", "--seq", "16", "--ckpt", str(tmp_path), "--ckpt-every", "2", "--device",
                "cpu"]

    out = train_cli.run(argv(3))
    assert out["final_step"] == 2 and np.isfinite(out["losses"]).all()
    assert "arch=qwen3-moe-smoke quant=bnn final_step=2" in capsys.readouterr().out
    again = train_cli.run(argv(4))
    assert again["final_step"] == 3 and len(again["losses"]) == 1
    assert "resumed from step 2" in capsys.readouterr().out
