"""The port's partitioner (``repro_torch.distributed.partitioner``) against
the JAX package's, leaf by leaf: parameter specs (FSDP off and on),
optimizer-state, batch and cache specs, the FSDP batch ladder and
``validate_specs``, for all ten architectures at full size on both
production meshes, (16, 16) and (2, 16, 16). The reference's rules are
called directly on a duck-typed mesh (they read only ``shape`` and
``axis_names``), on its own ``param_shapes`` / ``make_input_specs``; its
``PartitionSpec``s compare as tuples. Then ``to_placements``: specs to
DTensor placements, multi-axis dims in mesh order only.
"""

import types

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.data import make_input_specs as jax_input_specs
from repro.distributed import partitioner as jpart
from repro.launch import steps as jsteps
from repro.models.config import SHAPES as JSHAPES
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.data import make_input_specs
from repro_torch.distributed import partitioner as part
from repro_torch.launch import steps
from repro_torch.models.config import SHAPES

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def jax_mesh(names, sizes):
    return types.SimpleNamespace(shape=dict(zip(names, sizes)), axis_names=tuple(names))


def flat_jax(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jpart._path_of(kp): leaf for kp, leaf in leaves}


def flat_port(tree) -> dict:
    return {tree_lib.key(p): leaf for p, leaf in tree_lib.leaves_with_paths(tree)}


def assert_specs_equal(jax_specs, port_specs, what):
    fj, fp = flat_jax(jax_specs), flat_port(port_specs)
    assert fj.keys() == fp.keys(), (what, sorted(set(fj) ^ set(fp)))
    bad = {k: (fj[k], fp[k]) for k in fj if tuple(fj[k]) != tuple(fp[k])}
    assert not bad, (what, bad)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference_on_both_production_meshes(arch):
    j_params = jsteps.param_shapes(jax_config(arch))
    p_params = steps.param_shapes(get_config(arch))
    # the shapes the specs are inferred from: paths, shapes and dtypes
    fj, fp = flat_jax(j_params), flat_port(p_params)
    assert fj.keys() == fp.keys()
    for k in fj:
        assert tuple(fj[k].shape) == tuple(fp[k].shape), k
        assert str(fj[k].dtype) == str(fp[k].dtype).removeprefix("torch."), k
    for names, sizes in MESHES.values():
        jm, pm = jax_mesh(names, sizes), part.MeshShape(names, sizes)
        for fsdp in (False, True):
            jspec = jpart.infer_specs(j_params, jm, fsdp=fsdp)
            pspec = part.infer_specs(p_params, pm, fsdp=fsdp)
            assert_specs_equal(jspec, pspec, f"params {names} fsdp={fsdp}")
            assert part.validate_specs(p_params, pspec, pm) == []
            j_opt = jsteps.opt_shapes(j_params, jsteps.default_opt_cfg(jax_config(arch)))
            p_opt = steps.opt_shapes(p_params, steps.default_opt_cfg(get_config(arch)))
            assert_specs_equal(jpart.opt_state_specs(jspec, j_opt),
                               part.opt_state_specs(pspec, p_opt), f"opt {names} fsdp={fsdp}")
        for shape_name in SHAPES:
            j_in = jax_input_specs(jax_config(arch), JSHAPES[shape_name])
            p_in = make_input_specs(get_config(arch), SHAPES[shape_name])
            if SHAPES[shape_name].kind == "decode":
                assert_specs_equal(jpart.cache_specs(j_in["caches"], jm),
                                   part.cache_specs(p_in["caches"], pm), f"caches {shape_name}")
                j_in, p_in = j_in["token"], p_in["token"]
            for fsdp in (False, True):
                assert_specs_equal(jpart.batch_specs(j_in, jm, fsdp=fsdp),
                                   part.batch_specs(p_in, pm, fsdp=fsdp),
                                   f"batch {shape_name} {names} fsdp={fsdp}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fsdp_batch_ladder_and_data_axes_equal_the_reference(mesh):
    names, sizes = MESHES[mesh]
    jm, pm = jax_mesh(names, sizes), part.MeshShape(names, sizes)
    assert part.data_axes(pm) == jpart.data_axes(jm)
    for b in (1, 2, 8, 16, 24, 32, 128, 256, 512, 1024):
        assert part.fsdp_batch_axes(b, pm) == jpart.fsdp_batch_axes(b, jm), b


def test_specs_normalize_as_jax_partition_specs():
    for dims in ((("data",), None), ((), "model"), (("pod", "data"), None), ()):
        assert tuple(part.P(*dims)) == tuple(JP(*dims))
    assert part.P("data", None) == ("data", None)
    assert repr(part.P(None, "model")) == "P(None, 'model')"


def test_divisibility_fallback_and_violations():
    """An odd vocab cannot shard over 16: the table shards d instead, as
    the reference's (test_partitioner.py's synthetic case); a spec that
    does not divide is reported."""
    pm = part.MeshShape(("data", "model"), (16, 16))
    tree = {"embed": torch.empty((151655, 896), device="meta")}
    specs = part.infer_specs(tree, pm)
    assert specs["embed"] == (None, "model")
    bad = part.validate_specs(tree, {"embed": part.P("model", None)}, pm)
    assert len(bad) == 1 and bad[0].startswith("embed:")


def test_to_placements():
    pm = part.MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert part.to_placements(part.P(None, "data", "model"), pm) == (
        Replicate(), Shard(1), Shard(2))
    # a dim over several axes: Shard on each, in mesh order
    assert part.to_placements(part.P(("pod", "data", "model")), pm) == (
        Shard(0), Shard(0), Shard(0))
    assert part.to_placements(part.P(), pm) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        part.to_placements(part.P(("model", "data")), pm)
    with pytest.raises(ValueError, match="twice"):
        part.to_placements(part.P("data", "data"), pm)
    with pytest.raises(ValueError, match="not in mesh axes"):
        part.to_placements(part.P("expert"), pm)
    assert part.shard_factor(part.P(None, ("data", "model")), pm) == 256
