"""The paper-level BNN (``repro_torch.core.model``) against the JAX
package's ``repro.core.model``: the MLP and the LeNet-style conv net on
every engine, ``im2col``, the training forward's value, initializers
and the parameter conversion.

What is exact and what is not: every binary layer's ±1 input signs and
its integer output equal the JAX reference engine's, recorded call by
call, and within the port every engine equals ``reference`` bit for
bit. The logits pass through the fp32 edge layers (the first and last
``h @ w``, LeNet's first conv and its average pools), whose sums run in
another order on XLA than in PyTorch, so they are held to 1e-5 of their
largest magnitude (fp32 with at most 784-term sums).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import model as jmodel
from repro.core.crossbar import CrossbarSpec as JaxCrossbarSpec
from repro_torch.convert import params_dict
from repro_torch.core import engine as engine_lib
from repro_torch.core import model
from repro_torch.core.crossbar import CrossbarSpec

torch.set_num_threads(1)

ENGINES = ["reference", "tacitmap", "wdm", "packed", "tiled", "custbinarymap"]
# the reference test's small tiles (tests/test_bnn_model.py)
TILES = {"tacitmap": dict(rows=64, cols=32), "wdm": dict(rows=64, cols=32, technology="oPCM", wdm_k=4)}
LOGIT_TOL = 1e-5


class Recorder:
    """An engine stand-in for both packages' forwards: runs the real
    engine and keeps each binary layer's input signs and output."""

    def __init__(self, inner):
        self.inner, self.spec, self.calls = inner, inner.spec, []

    def binary_vmm(self, a, w):
        out = self.inner.binary_vmm(a, w)
        self.calls.append((np.asarray(a), np.asarray(out, np.float64)))
        return out


def _engines(name):
    kw = TILES.get(name)
    if kw is None:
        return engine_lib.get_engine(name), jengine.get_engine(name)
    return engine_lib.get_engine(name, CrossbarSpec(**kw)), jengine.get_engine(name, JaxCrossbarSpec(**kw))


def _check(got: torch.Tensor, want, port_rec: Recorder, jax_rec: Recorder) -> None:
    assert len(port_rec.calls) == len(jax_rec.calls) > 0
    for (pa, po), (ja, jo) in zip(port_rec.calls, jax_rec.calls):
        assert np.array_equal(pa, ja) and np.array_equal(po, jo)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())


@pytest.fixture(scope="module")
def mlp():
    cfg, jcfg = model.MLPConfig(), jmodel.MLPConfig()
    jparams = jmodel.init_mlp(jax.random.PRNGKey(0), jcfg)
    params = params_dict(jax.tree.map(np.asarray, jparams), device="cpu")
    x = np.random.default_rng(0).standard_normal((96, 784)).astype(np.float32)
    return cfg, jcfg, params, jparams, x


@pytest.fixture(scope="module")
def lenet():
    cfg, jcfg = model.ConvConfig(), jmodel.ConvConfig()
    jparams = jmodel.init_conv(jax.random.PRNGKey(1), jcfg)
    params = params_dict(jax.tree.map(np.asarray, jparams), device="cpu")
    x = np.random.default_rng(1).standard_normal((24, 28, 28, 1)).astype(np.float32)
    return cfg, jcfg, params, jparams, x


@pytest.mark.parametrize("name", ENGINES)
def test_mlp_on_every_engine_equals_the_reference(mlp, name):
    cfg, jcfg, params, jparams, x = mlp
    eng, jeng = _engines(name)
    rec, jrec = Recorder(eng), Recorder(jengine.get_engine("reference"))
    got = model.mlp_forward_infer(params, torch.from_numpy(x), cfg, rec)
    want = jmodel.mlp_forward_infer(jparams, jnp.asarray(x), jcfg, jrec)
    _check(got, want, rec, jrec)
    assert torch.equal(got, model.mlp_forward_infer(params, torch.from_numpy(x), cfg, "reference"))
    # the JAX engine of the same name on the same inputs
    assert np.array_equal(np.asarray(jmodel.mlp_forward_infer(jparams, jnp.asarray(x), jcfg, jeng)),
                          np.asarray(want))


@pytest.mark.parametrize("name", ENGINES)
def test_lenet_on_every_engine_equals_the_reference(lenet, name):
    cfg, jcfg, params, jparams, x = lenet
    eng, _ = _engines(name)
    rec, jrec = Recorder(eng), Recorder(jengine.get_engine("reference"))
    got = model.conv_forward(params, torch.from_numpy(x), cfg, train=False, engine=rec)
    want = jmodel.conv_forward(jparams, jnp.asarray(x), jcfg, train=False, engine=jrec)
    _check(got, want, rec, jrec)
    assert [a.shape for a, _ in rec.calls] == [(24, 8, 8, 150), (24, 256), (24, 120)]
    assert torch.equal(got, model.conv_forward(params, torch.from_numpy(x), cfg, train=False,
                                               engine="reference"))


def test_small_configs_and_engine_specs(mlp):
    """The reference test's small MLP and conv net through tacitmap and
    wdm on small tiles (engine instance plus a spec to rebind)."""
    for name in ("tacitmap", "wdm"):
        spec = CrossbarSpec(**TILES[name])
        jspec = JaxCrossbarSpec(**TILES[name])
        cfg, jcfg = model.MLPConfig(dims=(20, 32, 24, 5)), jmodel.MLPConfig(dims=(20, 32, 24, 5))
        jp = jmodel.init_mlp(jax.random.PRNGKey(0), jcfg)
        x = np.array(jax.random.normal(jax.random.PRNGKey(1), (6, 20)))
        got = model.mlp_forward_infer(params_dict(jax.tree.map(np.asarray, jp), device="cpu"),
                                      torch.from_numpy(x), cfg, name, spec)
        want = np.asarray(jmodel.mlp_forward_infer(jp, jnp.asarray(x), jcfg, name, jspec))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())
        ccfg = model.ConvConfig(in_hw=12, in_ch=1, convs=((4, 3), (8, 3)), pools=(1, 2), fcs=(16, 5))
        jccfg = jmodel.ConvConfig(in_hw=12, in_ch=1, convs=((4, 3), (8, 3)), pools=(1, 2),
                                  fcs=(16, 5))
        jp = jmodel.init_conv(jax.random.PRNGKey(0), jccfg)
        x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 12, 12, 1)))
        got = model.conv_forward(params_dict(jax.tree.map(np.asarray, jp), device="cpu"),
                                 torch.from_numpy(x), ccfg, train=False, engine=name, spec=spec)
        want = np.asarray(jmodel.conv_forward(jp, jnp.asarray(x), jccfg, train=False, engine=name,
                                              spec=jspec))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())


@pytest.mark.parametrize("shape,k,stride", [((2, 12, 12, 1), 3, 1), ((3, 28, 28, 1), 5, 1),
                                            ((2, 12, 12, 6), 5, 1), ((2, 11, 9, 3), 3, 2)])
def test_im2col_equals_the_reference(shape, k, stride):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    got = model.im2col(torch.from_numpy(x), k, stride)
    assert np.array_equal(got.numpy(), np.asarray(jmodel.im2col(jnp.asarray(x), k, stride)))


def test_training_forwards_equal_the_reference_value(mlp, lenet):
    """``mlp_forward_train`` and ``conv_forward(train=True)``: the same
    value as the reference's (its gradient is not ported)."""
    cfg, jcfg, params, jparams, x = mlp
    got = model.mlp_forward_train(params, torch.from_numpy(x), cfg)
    want = np.asarray(jmodel.mlp_forward_train(jparams, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())
    cfg, jcfg, params, jparams, x = lenet
    got = model.conv_forward(params, torch.from_numpy(x), cfg, train=True)
    want = np.asarray(jmodel.conv_forward(jparams, jnp.asarray(x), jcfg, train=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())


def test_binarize_reads_subnormals_as_zero():
    """The binary layers binarize by ``x > -2^-126``: a negative
    subnormal pre-activation gives +1, as the reference's ``x >= 0``
    under XLA."""
    cfg = model.MLPConfig(dims=(4, 3, 2, 1))
    params = {f"{p}{i}": v for i, (m, n) in enumerate(zip(cfg.dims[:-1], cfg.dims[1:]))
              for p, v in (("w", torch.ones(m, n)), ("b", torch.zeros(n)), ("g", torch.ones(n)))}
    rec = Recorder(engine_lib.get_engine("reference"))
    x = torch.tensor([[-1e-40, 0.0, 0.0, 0.0]])
    params["w0"] = torch.eye(4, 3)
    model.mlp_forward_infer(params, x, cfg, rec)
    assert rec.calls[0][0].tolist() == [[1.0, 1.0, 1.0]]


@pytest.mark.parametrize("cfg_kw", [dict(), dict(in_hw=12, convs=((4, 3), (8, 3)), pools=(1, 2),
                                                 fcs=(16, 5))])
def test_initializers_and_feature_dims_follow_the_reference(cfg_kw):
    cfg, jcfg = model.ConvConfig(**cfg_kw), jmodel.ConvConfig(**cfg_kw)
    assert model.conv_feature_dims(cfg) == jmodel.conv_feature_dims(jcfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init_conv(gen, cfg, device="cpu")
    jparams = jmodel.init_conv(jax.random.PRNGKey(0), jcfg)
    assert sorted(params) == sorted(jparams)
    for k, v in params.items():
        assert tuple(v.shape) == jparams[k].shape and v.dtype == torch.float32
        if k.startswith(("cw", "fw")):
            bound = 1 / math.sqrt(v.shape[0])
            assert float(v.abs().max()) <= bound
    mlp_cfg = model.MLPConfig()
    mp = model.init_mlp(gen, mlp_cfg, device="cpu")
    jmp = jmodel.init_mlp(jax.random.PRNGKey(0), jmodel.MLPConfig())
    assert {k: tuple(v.shape) for k, v in mp.items()} == {k: v.shape for k, v in jmp.items()}
    assert mlp_cfg.n_layers == 3 and dataclasses.astuple(mlp_cfg) == dataclasses.astuple(
        jmodel.MLPConfig())
