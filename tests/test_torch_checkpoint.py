"""The port's checkpoint manager: the reference's cases
(tests/test_checkpoint.py) on the port, checkpoints that restore across
the two packages, and ``save_async``'s snapshot under in-place updates."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_checkpoint
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jax_lm
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.checkpoint import (
    CheckpointManager,
    CorruptCheckpointError,
    restore_tree,
    save_tree,
)
from repro_torch.convert import params_from_jax, tree_to_jax
from repro_torch.models import lm
from repro_torch.optim import OptConfig, adamw_init

torch.set_num_threads(1)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((4, 8), generator=g),
        "nested": {"b": torch.arange(6, dtype=torch.int32), "c": torch.tensor(3.5)},
    }


def _assert_equal(got, want):
    for a, b in zip(jax.tree.leaves(tree_to_jax(got)), jax.tree.leaves(tree_to_jax(want)),
                    strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_roundtrip(tmp_path):
    t = _tree()
    save_tree(str(tmp_path / "ck"), t, {"step": 7})
    like = jax.tree.map(lambda x: torch.empty_like(x, device="meta"), t)
    got, extra = restore_tree(str(tmp_path / "ck"), like, device="cpu")
    assert extra["step"] == 7
    _assert_equal(got, t)


def test_incomplete_checkpoint_rejected(tmp_path):
    d = tmp_path / "ck"
    d.mkdir()
    (d / "manifest.json").write_text("{}")
    with pytest.raises(FileNotFoundError):
        restore_tree(str(d), _tree())


def test_manager_resume_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (10, 20, 30):
        mgr.save(s, t, {"step": s})
    assert mgr.latest_step() == 30
    assert mgr.steps() == [20, 30]  # keep=2 retention
    _, extra = mgr.restore(t)
    assert extra["step"] == 30


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = _tree(1)
    mgr.save_async(5, t)
    mgr.wait()
    got, extra = mgr.restore(t)
    assert extra["step"] == 5
    _assert_equal(got, t)


def test_restore_onto_a_device(tmp_path):
    """In place of the reference's shardings: restore onto the device
    asked for, else the ``like`` leaf's."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(2)
    mgr.save(1, t)
    got, _ = mgr.restore(jax.tree.map(lambda x: torch.empty_like(x, device="meta"), t),
                         device="cpu")
    assert got["a"].device.type == "cpu"
    got, _ = mgr.restore(t)
    assert got["nested"]["b"].device == t["nested"]["b"].device
    assert got["nested"]["b"].dtype == torch.int32


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    bad = _tree()
    bad["a"] = torch.zeros((2, 2))
    with pytest.raises(ValueError):
        mgr.restore(bad)


def test_crash_mid_write_leaves_previous_intact(tmp_path):
    """A stale .tmp dir (a simulated crash) must not shadow the good one."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(1, t)
    os.makedirs(str(tmp_path / "step_2.tmp-999"))  # crashed writer remnant
    assert mgr.latest_step() == 1
    _, extra = mgr.restore(t)
    assert extra["step"] == 1


def test_overwrite_is_atomic_and_updates(tmp_path):
    """Re-saving a step swaps snapshots without a window where the path
    names a partial dir; a stale .old aside (a crashed swap) is
    tolerated, never listed as a step."""
    path = str(tmp_path / "ck")
    save_tree(path, _tree(0), {"v": 1})
    os.makedirs(f"{path}.old-{os.getpid()}")  # stale aside from a crash
    save_tree(path, _tree(3), {"v": 2})
    like = _tree(3)
    got, extra = restore_tree(path, like)
    assert extra["v"] == 2
    _assert_equal(got, like)
    assert not os.path.exists(f"{path}.old-{os.getpid()}")
    mgr = CheckpointManager(str(tmp_path / "mgr"))
    mgr.save(1, _tree(0))
    mgr.save(1, _tree(1))
    assert mgr.steps() == [1]


def test_corrupt_manifest_named(tmp_path):
    d = tmp_path / "ck"
    save_tree(str(d), _tree())
    (d / "manifest.json").write_text("{not json")
    with pytest.raises(CorruptCheckpointError, match="manifest"):
        restore_tree(str(d), _tree())


def test_corrupt_arrays_named(tmp_path):
    d = tmp_path / "ck"
    save_tree(str(d), _tree())
    (d / "arrays.npz").write_bytes(b"\x00" * 16)  # truncated/garbled payload
    with pytest.raises(CorruptCheckpointError, match="arrays.npz"):
        restore_tree(str(d), _tree())


# -- across the two packages ---------------------------------------------------


def _train_state_pair(arch="qwen1.5-0.5b"):
    """The reference's (params, AdamW state) and the port's on the same
    values, in the stacked layout (factored, so ``v`` holds vr/vc)."""
    jparams = jax_lm.init_params(jax.random.key(0), jax_smoke_config(arch))
    jstate = jax_adamw_init(jparams, JaxOptConfig(factored=True))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    state = adamw_init(lm.param_tree(model), OptConfig(factored=True))
    g = torch.Generator().manual_seed(5)
    for t in jax.tree.leaves(state["m"]):
        t.copy_(torch.randn(t.shape, generator=g))
    state["step"].fill_(7)
    return jparams, jstate, model, state


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    jparams, jstate, model, state = _train_state_pair()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, (lm.param_tree(model), state), {"step": 7})
    assert os.path.exists(tmp_path / "step_7" / "COMPLETE")
    (p, s), extra = jax_checkpoint.CheckpointManager(str(tmp_path)).restore((jparams, jstate))
    assert extra["step"] == 7 and int(s["step"]) == 7
    for a, b in zip(jax.tree.leaves((p, s)),
                    jax.tree.leaves((tree_to_jax(lm.param_tree(model)), tree_to_jax(state))),
                    strict=True):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    keys = jax_checkpoint.manager._flatten((jparams, jstate)).keys()
    with np.load(tmp_path / "step_7" / "arrays.npz") as data:
        assert set(data.files) == set(keys)
    assert "0/blocks/slot0/attn/q/b" in keys and "1/v/blocks/slot0/ffn/w1/w/vc" in keys


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    jparams, jstate, model, state = _train_state_pair()
    jstate = dict(jstate, step=jnp.asarray(3, jnp.int32),
                  m=jax.tree.map(lambda x: x + 0.25, jstate["m"]))
    jparams = jax.tree.map(lambda x: x * 2, jparams)
    jax_checkpoint.CheckpointManager(str(tmp_path)).save(3, (jparams, jstate), {"step": 3})
    (p, s), extra = CheckpointManager(str(tmp_path)).restore(
        (lm.param_tree(model, device="meta"), state), device="cpu")
    lm.load_param_tree_(model, p)
    assert extra["step"] == 3 and int(s["step"]) == 3
    for a, b in zip(jax.tree.leaves((tree_to_jax(lm.param_tree(model)), tree_to_jax(s))),
                    jax.tree.leaves((jparams, jstate)), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_save_async_snapshots_before_an_in_place_update(tmp_path):
    """The optimizer updates its tensors in place: ``save_async`` must
    copy them before returning (a CPU tensor's ``.cpu()`` is the same
    storage), so an update right after the call never reaches the file."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(4)
    before = jax.tree.map(torch.clone, t)
    mgr.save_async(1, t)
    t["a"].add_(1.0)
    t["nested"]["b"].mul_(2)
    mgr.wait()
    got, _ = mgr.restore(t)
    _assert_equal(got, before)


def test_a_failed_async_write_raises_on_wait(tmp_path):
    """The writer thread's error is not lost: ``wait()`` raises it."""
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / f"step_1.tmp-{os.getpid()}").write_text("")  # a file where the dir goes
    mgr.save_async(1, _tree())
    with pytest.raises(FileExistsError):
        mgr.wait()
    assert mgr.steps() == []
    mgr.wait()  # raised once
