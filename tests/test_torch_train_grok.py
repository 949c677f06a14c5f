"""Training breadth, grok-1's smoke config (attention + MoE in every
layer, 4 experts, top-2): the port's ``lm.loss_fn`` and every gradient
leaf against the JAX package's, run op by op (tolerances:
tests/torch_grad_parity.py). The alpha = mean|w| sum order that moves
grok's seed-1 serving tokens (ROADMAP queue 3) moves no element of this
batch's forward: the loss agrees within 1e-6."""

import pytest
import torch

import torch_grad_parity as tp
from repro.models import lm as jax_lm

torch.set_num_threads(1)


@pytest.mark.parametrize("quant", ["none", "bnn"])
def test_grok_loss_and_every_gradient_leaf_match_the_reference(quant):
    jcfg, jparams, cfg, model, batch = tp.lm_case("grok-1-314b", quant)
    jloss, jgrads = tp.reference_value_and_grad(jax_lm.loss_fn, jparams, batch, jcfg)
    loss, grads = tp.port_lm_value_and_grad(model, batch, cfg)
    tp.assert_loss_and_grads_match(loss, grads, jloss, jgrads)
