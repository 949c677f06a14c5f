"""The port's activation hints (``repro_torch.distributed.hints``) against
the JAX package's: ``_resolve`` and ``_axis_size`` under every context
setting, ``hint`` as the identity outside the context and on a plain
tensor inside it; the hint sites of the ``tiled`` engine change nothing
on one device; and the MoE dispatch the mesh context selects in
``models.lm`` (the reference's ``lm._moe``). A DTensor's redistribution
under a hint runs in tests/test_torch_elastic.py's world.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.distributed import hints as jhints
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine as engine_lib
from repro_torch.distributed import ep as ep_lib
from repro_torch.distributed import hints
from repro_torch.distributed.partitioner import MeshShape
from repro_torch.models import lm

torch.set_num_threads(1)

NAMES, SIZES = ("pod", "data", "model"), (2, 8, 4)
AXES = ("dp", "dp_strict", "model", "model_strict", None, "data", "pod", "expert")
CONTEXTS = [dict(), dict(batch_axes=("data", "model"), tp=False), dict(batch_axes=("data",)),
            dict(tp=False)]


@pytest.mark.parametrize("kw", CONTEXTS, ids=lambda kw: str(kw) or "default")
def test_resolve_and_axis_size_equal_the_reference(kw):
    jm = types.SimpleNamespace(shape=dict(zip(NAMES, SIZES)), axis_names=NAMES)
    pm = MeshShape(NAMES, SIZES)
    with jhints.activation_hints(jm, **kw), hints.activation_hints(pm, **kw):
        assert hints.current_mesh() is pm
        for axis in AXES:
            r = hints._resolve(axis, pm)
            assert r == jhints._resolve(axis, jm), (axis, kw)
            assert hints._axis_size(r, pm) == jhints._axis_size(r, jm)
    assert hints.current_mesh() is None


def test_hint_is_identity_on_plain_tensors():
    x = torch.ones((4, 4))
    assert hints.hint(x, "dp", "model") is x
    with hints.activation_hints(MeshShape(NAMES, SIZES)):
        assert hints.hint(x, "dp", "model") is x


def test_tiled_engine_under_a_mesh_context_is_unchanged():
    """The ``tiled`` engine's two hint sites (the reference's
    engine.py:740, :755) leave a one-device execute bit for bit."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(np.where(rng.standard_normal((96, 40)) >= 0, 1.0, -1.0).astype(np.float32))
    a = torch.from_numpy(np.where(rng.standard_normal((3, 96)) >= 0, 1.0, -1.0).astype(np.float32))
    eng = engine_lib.get_engine("tiled")
    pw = eng.prepare(w)
    want = eng.binary_vmm(a, pw)
    with hints.activation_hints(MeshShape(("data", "model"), (2, 4))):
        got = eng.binary_vmm(a, pw)
    assert torch.equal(got, want)
    assert torch.equal(want, a @ w)


def test_mesh_context_selects_the_moe_dispatch(monkeypatch):
    """``moe_impl="ep_shard_map"`` under a mesh whose ``model`` axis
    divides the experts calls ``ep_moe_ffn``; any other case calls
    ``moe_ffn``, as the reference's ``lm._moe`` does."""
    calls = []

    def fake_ep(p, x, cfg, mesh, axis="model"):
        calls.append(mesh)
        return torch.zeros_like(x), torch.zeros(())

    monkeypatch.setattr(ep_lib, "ep_moe_ffn", fake_ep)
    cfg = get_smoke_config("qwen3-moe-235b-a22b")  # 8 experts
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    p = model.blocks[0].ffn
    x = torch.randn((2, 4, cfg.d_model)).to(torch.bfloat16)
    want = lm.moe_lib.moe_ffn(p, x, cfg)[0]
    ep_cfg = dataclasses.replace(cfg, moe_impl="ep_shard_map")
    for mesh, c, expect_ep in (
        (MeshShape(("data", "model"), (2, 4)), ep_cfg, True),
        (MeshShape(("data", "model"), (2, 4)), cfg, False),      # pjit impl
        (MeshShape(("data", "model"), (2, 3)), ep_cfg, False),   # 8 % 3 != 0
        (MeshShape(("data",), (2,)), ep_cfg, False),             # no model axis
        (None, ep_cfg, False),                                   # no mesh
    ):
        calls.clear()
        with hints.activation_hints(mesh):
            y, _ = lm._moe(p, x, c)
        assert bool(calls) == expect_ep, (mesh, c.moe_impl)
        if not expect_ep:
            assert torch.equal(y, want)
