"""Training breadth, the VLM: internvl2's smoke config with its stub
patch embeddings prepended (``extra_embeds``, 8 patches before 16
tokens). The port's ``lm.loss_fn`` and every gradient leaf against the
JAX package's, run op by op (tolerances: tests/torch_grad_parity.py),
and the VLM training CLI."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_grad_parity as tp
from repro.models import lm as jax_lm
from repro_torch.configs import get_smoke_config
from repro_torch.data import lm_batch
from repro_torch.launch import train as train_cli
from repro_torch.models import lm

torch.set_num_threads(1)

ARCH = "internvl2-1b"


@pytest.mark.parametrize("quant", ["none", "bnn"])
def test_vlm_loss_and_every_gradient_leaf_match_the_reference(quant):
    jcfg, jparams, cfg, model, batch = tp.lm_case(ARCH, quant)
    assert batch["extra_embeds"].shape == (tp.BATCH, cfg.frontend_len, cfg.d_model)
    jloss, jgrads = tp.reference_value_and_grad(jax_lm.loss_fn, jparams, batch, jcfg)
    loss, grads = tp.port_lm_value_and_grad(model, batch, cfg)
    tp.assert_loss_and_grads_match(loss, grads, jloss, jgrads)


def test_vlm_loss_reads_only_the_token_rows():
    """The patch rows carry no target: the loss is the mean over the
    tokens' next-token targets, whatever the patches hold only through
    attention, and moving the patches moves the loss."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), quant="bnn")
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = lm_batch(cfg, 2, 12, seed=3, device="cpu")
    with torch.no_grad():
        loss = lm.loss_fn(model, batch, cfg)
        hidden, _ = lm.backbone(model, torch.cat([batch["extra_embeds"],
                                                  model.embed[batch["tokens"]]], dim=1),
                                torch.arange(cfg.frontend_len + 12), cfg)
        targets = torch.cat([batch["tokens"][:, 1:], torch.full((2, 1), -1)], dim=1)
        want = lm.lm_loss(model, hidden[:, cfg.frontend_len:], targets, cfg)
        moved = lm.loss_fn(model, dict(batch, extra_embeds=batch["extra_embeds"] * 2), cfg)
    assert torch.equal(loss, want) and not torch.equal(loss, moved)


def test_train_cli_trains_a_vlm(tmp_path):
    out = train_cli.run(["--arch", ARCH, "--smoke", "--quant", "bnn", "--steps", "2",
                         "--batch", "2", "--seq", "16", "--ckpt", str(tmp_path), "--device",
                         "cpu"])
    assert out["final_step"] == 1 and np.isfinite(out["losses"]).all()
