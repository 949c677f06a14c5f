"""The port's expert-parallel MoE (``repro_torch.distributed.ep``) against
the JAX package's ``ep.py``, on the qwen3-moe smoke config (8 experts,
top-4).

* ``_local_dispatch`` on the reference's own router logits: buckets,
  expert ids, source tokens, destinations, slots, keep mask and top-k
  equal bit for bit; the gates within 1e-6 (the softmax's sum runs in
  another order, as tests/test_torch_moe.py holds ``moe.route``).
* EP on 2 and 4 gloo ranks against two oracles. (1) The reference's EP
  composed on one device: its per-rank ``_local_dispatch``, a numpy
  all-to-all, its ``_expert_ffn`` and its combine, within one bf16 ulp
  of the output's largest magnitude (2^-8 of it; the expert products
  accumulate in another order). (2) The reference ``moe_ffn`` at
  drop-free capacity within 3e-2 (the reference test's bound,
  test_multidevice.py: EP combines in bf16, ``moe_ffn`` in fp32). The
  aux loss within 1e-6 of the composed reference's. Gradients: finite,
  ``w1``'s nonzero, within 3e-2 of the largest magnitude of the
  reference ``moe_ffn``'s single-process gradient.
* ``lm.prefill`` with ``moe_impl="ep_shard_map"`` under the mesh
  context: each rank's logits within 3e-2 of the largest of the
  single-process prefill's (``moe_ffn``).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.distributed import ep as jep
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import ep
from torch_dist import ep_worker, run_world

torch.set_num_threads(1)

B, S = 8, 16
ULP = 2.0**-8


def _setup():
    jcfg = dataclasses.replace(jax_smoke_config("qwen3-moe-235b-a22b"), moe_capacity_factor=64.0)
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), moe_capacity_factor=64.0)
    params = {k: np.asarray(v) for k, v in jmoe.moe_init(jax.random.key(0), jcfg).items()}
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))  # bf16 values
    return jcfg, cfg, params, x


def _composed_reference(jcfg, params, x, n_ranks):
    """The reference's EP body run rank by rank on one device, the
    all_to_all done in numpy."""
    e, k, d = jcfg.moe_experts, jcfg.moe_top_k, jcfg.d_model
    e_local = e // n_ranks
    rows = B // n_ranks
    t_local = rows * S
    cap = max(1, math.ceil(t_local * k / n_ranks * jcfg.moe_capacity_factor))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    per = []
    for r in range(n_ranks):
        x2d = xb[r * rows:(r + 1) * rows].reshape(t_local, d)
        logits = x2d.astype(jnp.float32) @ jnp.asarray(params["router"])
        per.append((logits, *jep._local_dispatch(x2d, logits, n_ranks, e_local, k, cap)))
    recv = [jnp.stack([per[j][1][r] for j in range(n_ranks)]) for r in range(n_ranks)]
    recv_eid = [jnp.stack([per[j][2][r] for j in range(n_ranks)]) for r in range(n_ranks)]
    out_e = []
    for r in range(n_ranks):
        sl = slice(r * e_local, (r + 1) * e_local)
        out_e.append(jep._expert_ffn(
            recv[r].reshape(n_ranks * cap, d), recv_eid[r].reshape(-1),
            *(jnp.asarray(params[n][sl]) for n in ("w1", "w3", "w2"))).reshape(n_ranks, cap, d))
    ys, auxes = [], []
    for r in range(n_ranks):
        logits, _, _, _, gates, top_idx, dest, slot, keep = per[r]
        back = jnp.stack([out_e[j][r] for j in range(n_ranks)])
        got = back[dest, slot] * keep[:, None]
        y = (got.reshape(t_local, k, d) * gates[..., None].astype(got.dtype)).sum(axis=1)
        ys.append(np.asarray(y.astype(jnp.float32)).reshape(rows, S, d))
        onehot_e = jax.nn.one_hot(top_idx.reshape(-1), e, dtype=jnp.float32)
        frac = onehot_e.mean(axis=0) * e / k
        mean_prob = jax.nn.softmax(logits, axis=-1).mean(axis=0)
        auxes.append(float(jnp.sum(frac * mean_prob) * e / e))
    return np.concatenate(ys), float(np.mean(auxes))


@pytest.mark.parametrize("n_ranks,factor", [(2, 64.0), (4, 64.0), (2, 0.5), (4, 0.25)],
                         ids=["R2-dropfree", "R4-dropfree", "R2-drops", "R4-drops"])
def test_local_dispatch_is_bit_exact(n_ranks, factor):
    jcfg, cfg, params, x = _setup()
    e_local, k = cfg.moe_experts // n_ranks, cfg.moe_top_k
    x2d_np = x[: B // n_ranks].reshape(-1, cfg.d_model)
    t = x2d_np.shape[0]
    cap = max(1, math.ceil(t * k / n_ranks * factor))
    jx = jnp.asarray(x2d_np).astype(jnp.bfloat16)
    jlogits = jx.astype(jnp.float32) @ jnp.asarray(params["router"])
    want = [np.asarray(a) for a in jep._local_dispatch(jx, jlogits, n_ranks, e_local, k, cap)]
    got = ep._local_dispatch(torch.from_numpy(x2d_np).to(torch.bfloat16),
                             torch.from_numpy(np.asarray(jlogits)), n_ranks, e_local, k, cap)
    names = ("send", "send_eid", "send_tok", "gates", "top_idx", "dest", "slot", "keep")
    for name, w, g in zip(names, want, got, strict=True):
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        w = w.astype(np.float32) if w.dtype == jnp.bfloat16 else w
        if name == "gates":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    if factor < 1:
        assert not want[-1].all()  # the tight capacity drops some assignments


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_ep_on_gloo_ranks_matches_both_oracles(n_ranks, tmp_path):
    jcfg, cfg, params, x = _setup()
    composed, composed_aux = _composed_reference(jcfg, params, x, n_ranks)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    ref, _ = jmoe.moe_ffn(jparams, jx, jcfg)
    ref = np.asarray(ref.astype(jnp.float32))
    ref_grad = np.asarray(jax.grad(
        lambda p: jnp.sum(jmoe.moe_ffn(p, jx, jcfg)[0].astype(jnp.float32) ** 2))(jparams)["w1"])
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2 * n_ranks, S))
    res = run_world(ep_worker, n_ranks, tmp_path,
                    {"cfg": cfg, "params": params, "x": x, "tokens": tokens})

    y = np.concatenate([r["y"].numpy() for r in res])
    scale = np.abs(composed).max()
    assert np.abs(y - composed).max() <= ULP * scale, np.abs(y - composed).max()
    np.testing.assert_allclose(y, ref, atol=3e-2, rtol=3e-2)
    assert all(abs(r["aux"] - composed_aux) <= 1e-6 for r in res)
    grad = np.concatenate([r["w1_grad"].numpy() for r in res])
    assert np.isfinite(grad).all() and np.abs(grad).max() > 0
    assert np.abs(grad - ref_grad).max() <= 3e-2 * np.abs(ref_grad).max()
    for r in res:
        single = r["single_logits"].numpy()
        assert np.abs(r["ep_logits"].numpy() - single).max() <= 3e-2 * np.abs(single).max()
