"""The step-0 finding of the hybrid stack's training parity, pinned:
jamba's binarized smoke forward (weights ``jax.random.key(0)``, tokens
``default_rng(1)`` of shape (2, 16)) leaves the reference's first at
layer 2's Mamba ``z_proj``, a bf16 GEMM rounding at a bf16 midpoint
(ROADMAP queue 3; the parity tests are tests/test_torch_train_jamba.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_grad_parity as tp
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models import ssm as jax_ssm
from repro_torch.models import layers, lm, ssm

torch.set_num_threads(1)


def _reference_layer(jh, sp, kind, positions, jcfg):
    """One layer of the reference's ``_apply_repeat``."""
    hn = jax_layers.rms_norm(jh, sp["norm1"], jcfg.norm_eps)
    if kind.mixer == "attn":
        mix, _ = jax_layers.attention_block(sp["attn"], hn, positions, jcfg, quant=jcfg.quant)
    else:
        mix, _ = jax_ssm.mamba_block(sp["mamba"], hn, jcfg)
    jh = jh + mix
    hn = jax_layers.rms_norm(jh, sp["norm2"], jcfg.norm_eps)
    f = (jax_moe.moe_ffn(sp["moe"], hn, jcfg)[0] if kind.moe
         else jax_layers.ffn(sp["ffn"], hn, jcfg.quant))
    return jh + f


def test_jamba_first_difference_is_a_gemm_rounding_at_a_bf16_midpoint():
    """The step-0 finding, pinned: layers 0 and 1 equal the reference's
    bit for bit; layer 2's Mamba ``z_proj`` differs in exactly one
    element by one bf16 ulp, the reference's value there is the exact
    product rounded to bf16 and the port's its neighbour, and the exact
    value lies within a hundredth of an ulp of their midpoint."""
    jcfg, jparams, cfg, model, batch = tp.lm_case("jamba-1.5-large-398b", "bnn")
    tokens = batch["tokens"]
    with jax.disable_jit(), torch.no_grad():
        h = model.embed[torch.from_numpy(tokens).long()].to(torch.bfloat16)
        jh = jparams["embed"][jnp.asarray(tokens)].astype(jnp.bfloat16)
        positions = torch.arange(tokens.shape[1])
        for layer in range(2):  # slots 0 and 1 of repeat 0
            blk = model.blocks[layer]
            hn = layers.rms_norm(h, blk.norm1, cfg.norm_eps)
            h = lm._ffn_residual(blk, h + lm._mix(blk, hn, positions, cfg, None)[0], cfg,
                                 None)[0]
            sp = jax.tree.map(lambda x: x[0], jparams["blocks"][f"slot{layer}"])
            jh = _reference_layer(jh, sp, jcfg.pattern[layer], jnp.arange(tokens.shape[1]), jcfg)
            np.testing.assert_array_equal(tp.to_numpy(h), tp.to_numpy(jh))
        mixer = model.blocks[2].mixer
        u = layers.rms_norm(h, model.blocks[2].norm1, cfg.norm_eps)
        jsp = jax.tree.map(lambda x: x[0], jparams["blocks"]["slot2"])["mamba"]
        ju = jax_layers.rms_norm(jh, jparams["blocks"]["slot2"]["norm1"][0], jcfg.norm_eps)
        np.testing.assert_array_equal(tp.to_numpy(u), tp.to_numpy(ju))
        port = tp.to_numpy(ssm._project(mixer, u, "z_proj"))
        ref = tp.to_numpy(jax_ssm._project(jsp, ju, "z_proj"))
        exact = u.double() @ mixer.z_proj.to(torch.bfloat16).double()
    np.testing.assert_array_equal(ref, tp.to_numpy(exact.to(torch.bfloat16)))
    (at,) = np.argwhere(port != ref)
    at = tuple(at)
    ulp = 2.0 ** (np.floor(np.log2(abs(ref[at]))) - 7)
    assert abs(port[at] - ref[at]) == ulp
    assert abs(float(exact[at]) - (port[at] + ref[at]) / 2) < ulp / 100


