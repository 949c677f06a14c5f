"""The port's GPipe (``repro_torch.distributed.pipeline``) on a 4-rank gloo
world against the sequential run: the reference test's tanh stages
(test_multidevice.py: within 1e-5 forward, 1e-4 for the gradients, the
sequential oracle from the JAX package), and a smoke tinyllama backbone
of one block per stage -- programmed on ``packed``, equal bit for bit
(every per-row op gives a row the same bits whatever the microbatch);
latent (plain bf16 products), within 2e-2 of the largest magnitude
forward and for each stage's parameter gradients (a CPU GEMM rounds a
2-row product differently from an 8-row one). Plus the split and the
bubble.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.distributed.pipeline import bubble_fraction as jax_bubble
from repro.distributed.pipeline import stage_split as jax_split
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.pipeline import bubble_fraction, stage_split
from torch_dist import pipeline_worker, run_world

torch.set_num_threads(1)


def test_stage_split_and_bubble_equal_the_reference():
    for n_layers in (1, 4, 22, 23, 94):
        for n_stages in (1, 2, 3, 4, 16):
            assert stage_split(n_layers, n_stages) == jax_split(n_layers, n_stages)
    for p, m in ((2, 4), (4, 4), (16, 64), (1, 1)):
        assert bubble_fraction(p, m) == jax_bubble(p, m)


def test_gpipe_equals_sequential_with_gradients(tmp_path):
    n_stages, layers, d = 4, 2, 16
    ws = np.asarray(jax.random.normal(jax.random.key(0), (n_stages, layers, d, d)) * 0.3)
    x = np.asarray(jax.random.normal(jax.random.key(1), (8, d)))

    def stage_fn(sp, h):
        for i in range(layers):
            h = jnp.tanh(h @ sp[i])
        return h

    def loss_seq(ws_):
        h = jnp.asarray(x)
        for s in range(n_stages):
            h = stage_fn(ws_[s], h)
        return h

    seq = np.asarray(loss_seq(jnp.asarray(ws)))
    seq_grad = np.asarray(jax.grad(lambda w: jnp.sum(loss_seq(w) ** 2))(jnp.asarray(ws)))
    cfg = dataclasses.replace(get_smoke_config("tinyllama-1.1b"), n_layers=n_stages)
    h = np.random.default_rng(0).standard_normal((8, 16, cfg.d_model)).astype(np.float32)
    res = run_world(pipeline_worker, n_stages, tmp_path, {"ws": ws, "x": x, "cfg": cfg, "h": h})
    for r, out in enumerate(res):
        np.testing.assert_allclose(out["tanh"].numpy(), seq, atol=1e-5)
        np.testing.assert_allclose(out["tanh_grad"].numpy(), seq_grad[r], atol=1e-4)
        assert torch.equal(out["packed_pipe"], out["packed_seq"])
        lat, lat_seq = out["latent_pipe"].float(), out["latent_seq"].float()
        assert (lat - lat_seq).abs().max() <= 2e-2 * lat_seq.abs().max()
        for g, want in zip(out["pipe_grads"], out["seq_grads"], strict=True):
            assert torch.isfinite(g).all()
            assert (g - want).abs().max() <= 2e-2 * want.abs().max()
