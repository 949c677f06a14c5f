"""Training the hybrid stack: jamba's smoke config (Mamba, attention + MoE,
Mamba, Mamba + MoE) against the JAX package's, loss and every gradient
leaf (tolerances: tests/torch_grad_parity.py).

With ``quant="bnn"`` the port's loss departs from the reference's by
5.6e-5 relative on the parity batch (weights ``jax.random.key(0)``,
tokens ``default_rng(1)`` of shape (2, 16)). Run op by op, the first op
whose output differs is layer 2's Mamba ``z_proj``, a bf16 GEMM: one
element of 4096, one bf16 ulp, where the exact product lies a hundredth
of an ulp from a bf16 midpoint and the two libraries' fp32 sums land on
either side of it; ``out_proj`` of the same layer does the same, and
``softplus`` / ``exp`` differ by an fp32 ulp on some elements. The
one-ulp step in layer 2's output moves layer 3 and its MoE routing.
That is a sum order and a transcendental's last bit, not a port fault
(ROADMAP queue 3; the first differing op is pinned by
tests/test_torch_train_jamba_step0.py); given the reference's values of those
ops the port matches it.
"""

import pytest
import torch

import torch_grad_parity as tp
from repro.models import lm as jax_lm
from repro_torch.models import lm

torch.set_num_threads(1)

ARCH = "jamba-1.5-large-398b"


@pytest.mark.parametrize("quant", ["none", "bnn"])
def test_jamba_loss_and_every_gradient_leaf_match_the_reference(quant, monkeypatch):
    """quant none as it stands; quant bnn, whose loss as it stands
    departs by more than the tolerance, given the reference's values of
    the Mamba GEMMs, ``softplus`` and ``exp`` (the step-0 finding),
    each with the port's own gradient."""
    jcfg, jparams, cfg, model, batch = tp.lm_case(ARCH, quant)
    jloss, jgrads = tp.reference_value_and_grad(jax_lm.loss_fn, jparams, batch, jcfg)
    if quant == "bnn":
        with torch.no_grad():
            alone = float(lm.loss_fn(model, {"tokens": torch.from_numpy(batch["tokens"])}, cfg))
        assert abs(alone - jloss) > tp.LOSS_RTOL * abs(jloss)
        tp.given_reference_mamba_numerics(monkeypatch)
    loss, grads = tp.port_lm_value_and_grad(model, batch, cfg)
    tp.assert_loss_and_grads_match(loss, grads, jloss, jgrads,
                                   tp.DEEP_TOL if quant == "bnn" else tp.LEAF_TOL)
