"""The port's int8 error-feedback compression
(``repro_torch.distributed.compression``) and collectives
(``repro_torch.distributed.collectives``) against the JAX package's.

* ``_quantize`` / ``compress_grads`` / ``decompress_grads`` bit for bit
  on seeded numpy trees, with ties at .5 (round half to even), an
  all-zero leaf (the 1e-30 scale floor), ±absmax leaves and a carried
  residual.
* On a 4-rank gloo world: the collectives' values (all-reduce mean,
  reduce-scatter on dim 0 and 1, all-gather, ring shifts both ways,
  all-to-all) and the ring shift's gradient (the reverse shift); then
  ``compressed_all_reduce_mean`` over a 2-rank group equal bit for bit to
  the reference's arithmetic -- the mean of the two ranks' dequantized
  payloads, (p0 + p1) / 2 -- with the residual x - dequantize(quantize(x))
  on each rank, and a second call carrying it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.distributed import compression as jcomp
from repro_torch.distributed import compression
from torch_dist import collectives_worker, run_world

torch.set_num_threads(1)


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "blocks": {"w": (rng.standard_normal((6, 5)) * 3).astype(f32),
                   "b": rng.standard_normal((7,)).astype(f32)},
        # absmax 127 -> scale 1: every x.5 is a tie, rounded half to even
        "ties": np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 3.0], f32),
        "zeros": np.zeros((4,), f32),
        "absmax": np.array([-7.25, 7.25, 1e-3, -1e-3], f32),
        "tiny": (rng.standard_normal((3, 3)) * 1e-20).astype(f32),
    }


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _assert_trees_equal(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{what}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_quantize_is_bit_exact():
    for leaf in jax.tree.leaves(_tree(0)):
        q, s = compression._quantize(torch.from_numpy(leaf))
        jq, js = jcomp._quantize(jnp.asarray(leaf))
        _assert_trees_equal({"q": q.numpy(), "s": s.numpy()}, {"q": jq, "s": js})
    q, _ = compression._quantize(torch.from_numpy(_tree(0)["ties"]))
    assert q.tolist() == [127, 2, -4, 0, 0, 2, -126, 3]


def test_compress_and_decompress_are_bit_exact_with_a_carried_residual():
    grads = _tree(1)
    state = {k: v for k, v in _tree(2).items()}  # a nonzero residual
    jc, je = jcomp.compress_grads(jax.tree.map(jnp.asarray, grads),
                                  jax.tree.map(jnp.asarray, state))
    tg = jax.tree.map(torch.from_numpy, grads)
    pc, pe = compression.compress_grads(tg, jax.tree.map(torch.from_numpy, state))
    _assert_trees_equal(_np(pc), jax.tree.map(np.asarray, jc))
    _assert_trees_equal(_np(pe), jax.tree.map(np.asarray, je))
    _assert_trees_equal(_np(compression.decompress_grads(pc)),
                        jax.tree.map(np.asarray, jcomp.decompress_grads(jc)))
    _assert_trees_equal(_np(compression.ef_init(tg)),
                        jax.tree.map(np.asarray, jcomp.ef_init(grads)))


def test_collectives_and_compressed_all_reduce_on_gloo_ranks(tmp_path):
    x = np.random.default_rng(3).standard_normal((4, 4, 6)).astype(np.float32)
    per_rank = [_tree(10), _tree(11)]
    res = run_world(collectives_worker, 4, tmp_path, {"x": x, "grads": per_rank})
    for r, out in enumerate(res):
        np.testing.assert_allclose(out["mean"].numpy(), x.mean(axis=0), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out["scatter"].numpy(), x.mean(axis=0)[r:r + 1],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out["scatter1"].numpy(), x[:, :, :4].mean(axis=0)[:, r:r + 1],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(out["gather"].numpy(), np.concatenate(list(x), axis=1))
        np.testing.assert_array_equal(out["shift"].numpy(), x[(r - 1) % 4])
        np.testing.assert_array_equal(out["shift_back"].numpy(), x[(r + 2) % 4])
        np.testing.assert_array_equal(out["a2a"].numpy(), x[:, r])
        assert out["transport"] == "device"
        # d/dx_r of sum(shift(x) * c) = c, received back from rank r + 1
        np.testing.assert_array_equal(out["shift_grad"].numpy(),
                                      np.broadcast_to(np.arange(6.0, dtype=np.float32), (4, 6)))
    # the reference's arithmetic, rank by rank: payload = dequantize(quantize(g + e))
    payloads, residuals = [], []
    for g in per_rank:
        comp, ef = jcomp.compress_grads(jax.tree.map(jnp.asarray, g), jcomp.ef_init(g))
        payloads.append(jcomp.decompress_grads(comp))
        residuals.append(ef)
    want = jax.tree.map(lambda a, b: (a + b) / 2, *payloads)
    for r in (0, 1):
        _assert_trees_equal(_np(res[r]["reduced"]), jax.tree.map(np.asarray, want))
        _assert_trees_equal(_np(res[r]["ef"]), jax.tree.map(np.asarray, residuals[r]))
    # a second call compresses g + the residual
    payloads2, residuals2 = [], []
    for g, e in zip(per_rank, residuals):
        comp, ef = jcomp.compress_grads(jax.tree.map(jnp.asarray, g), e)
        payloads2.append(jcomp.decompress_grads(comp))
        residuals2.append(ef)
    want2 = jax.tree.map(lambda a, b: (a + b) / 2, *payloads2)
    for r in (0, 1):
        _assert_trees_equal(_np(res[r]["reduced2"]), jax.tree.map(np.asarray, want2))
        _assert_trees_equal(_np(res[r]["ef2"]), jax.tree.map(np.asarray, residuals2[r]))
    assert "reduced" not in res[2] and "reduced" not in res[3]
