"""The port's step cells (``repro_torch.launch.steps``) and dry-run inputs
(``data.make_input_specs`` / ``token_count``) against the JAX package's:
the optimizer choice and the FSDP decision for every architecture x
shape on both production meshes, the input specs' shapes and dtypes,
and, on the smoke configs, each cell's argument and output shapes
(a prefill's caches against ``jax.eval_shape`` of the reference's
prefill). Everything is ``meta``: nothing is allocated.
"""

import dataclasses
import types

import jax
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import make_input_specs as jax_input_specs
from repro.data import token_count as jax_token_count
from repro.launch import steps as jsteps
from repro.models.config import SHAPES as JSHAPES
from repro.models.config import ShapeConfig as JShapeConfig
from repro.models.config import shape_applicable as jax_applicable
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import make_input_specs, token_count
from repro_torch.distributed import partitioner as part
from repro_torch.launch import steps
from repro_torch.models.config import SHAPES, ShapeConfig, shape_applicable

MESHES = ((("data", "model"), (16, 16)), (("pod", "data", "model"), (2, 16, 16)))


def shapes_of(tree, flatten) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in flatten(tree)}


def jax_flat(tree):
    from repro.distributed.partitioner import _path_of

    return [(_path_of(kp), v) for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def port_flat(tree):
    return [(tree_lib.key(p), v) for p, v in tree_lib.leaves_with_paths(tree)]


def test_shapes_equal_the_reference():
    assert {n: dataclasses.astuple(s) for n, s in SHAPES.items()} == {
        n: dataclasses.astuple(s) for n, s in JSHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_choices_and_input_specs_equal_the_reference(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    assert steps.default_opt_cfg(cfg).factored == jsteps.default_opt_cfg(jcfg).factored
    for name, shape in SHAPES.items():
        assert shape_applicable(cfg, shape) == jax_applicable(jcfg, JSHAPES[name])
        assert token_count(shape) == jax_token_count(JSHAPES[name])
        for names, sizes in MESHES:
            jm = types.SimpleNamespace(shape=dict(zip(names, sizes)), axis_names=names)
            assert steps.train_wants_fsdp(cfg, shape, part.MeshShape(names, sizes)) == \
                jsteps.train_wants_fsdp(jcfg, JSHAPES[name], jm), (name, names)
        got = make_input_specs(cfg, shape)
        assert shapes_of(got, port_flat) == shapes_of(jax_input_specs(jcfg, JSHAPES[name]),
                                                      jax_flat), name
        assert all(t.device.type == "meta" for t in tree_lib.leaves(got))


SMOKE_SHAPES = (ShapeConfig("t", 64, 4, "train"), ShapeConfig("p", 64, 4, "prefill"),
                ShapeConfig("d", 64, 4, "decode"))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-235b-a22b", "mamba2-2.7b",
                                  "seamless-m4t-large-v2", "internvl2-1b",
                                  "jamba-1.5-large-398b"])
def test_smoke_cells_have_the_reference_shapes(arch):
    """The mini dry-run's cell kinds (the reference's
    test_mini_dryrun_all_cell_kinds) on a (2, 4) mesh: arguments and
    outputs shaped as the reference's cell, specs that divide, one
    placement per mesh dim for every leaf."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    mesh = part.MeshShape(("data", "model"), (2, 4))
    jm = types.SimpleNamespace(shape={"data": 2, "model": 4}, axis_names=("data", "model"))
    for sh in SMOKE_SHAPES:
        jsh = JShapeConfig(sh.name, sh.seq_len, sh.global_batch, sh.kind)
        cell = steps.build_cell(cfg, sh, mesh)
        args = cell["args"]
        assert shapes_of(args[0], port_flat) == shapes_of(jsteps.param_shapes(jcfg), jax_flat)
        if sh.kind == "train":
            j_opt = jsteps.opt_shapes(jsteps.param_shapes(jcfg), jsteps.default_opt_cfg(jcfg))
            assert shapes_of(args[1], port_flat) == shapes_of(j_opt, jax_flat)
            assert cell["donate_argnums"] == (0, 1)
            assert cell["hint_kw"] == ({"batch_axes": ("data", "model"), "tp": False}
                                       if jsteps.train_wants_fsdp(jcfg, jsh, jm) else {})
        elif sh.kind == "prefill":
            jspecs = jax_input_specs(jcfg, jsh)
            if jcfg.is_encdec:
                from repro.models import encdec as jenc

                out = jax.eval_shape(lambda p, b: jenc.prefill(p, b["src_embeds"], b["tokens"],
                                                               jcfg),
                                     jsteps.param_shapes(jcfg), jspecs)
            else:
                from repro.models import lm as jlm

                out = jax.eval_shape(lambda p, b: jlm.prefill(p, b["tokens"], jcfg,
                                                              b.get("extra_embeds")),
                                     jsteps.param_shapes(jcfg), jspecs)
            assert shapes_of(cell["out"][1], port_flat) == shapes_of(out[1], jax_flat)
            assert tuple(cell["out"][0].shape) == tuple(out[0].shape)
        else:
            assert cell["donate_argnums"] == (3,)
            assert shapes_of(args[3], port_flat) == shapes_of(
                jax_input_specs(jcfg, jsh)["caches"], jax_flat)
        for tree, specs in [*zip(args, cell["in_specs"]), *zip(cell["out"], cell["out_specs"])]:
            assert part.validate_specs(tree, specs, mesh) == []
            assert all(t.device.type == "meta" for t in tree_lib.leaves(tree))
        for specs, placements in zip(cell["in_specs"], cell["in_placements"]):
            for path, spec in tree_lib.leaves_with_paths(specs):
                assert tree_lib.get(placements, path) == part.to_placements(spec, mesh)


def test_param_shapes_allocate_nothing():
    """jamba's 398 B parameters as meta tensors; bf16 matrices, fp32 1-D."""
    tree = steps.param_shapes(get_config("jamba-1.5-large-398b"))
    leaves = tree_lib.leaves(tree)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) > 397e9
    assert {t.dtype for t in leaves if t.ndim >= 2} == {torch.bfloat16}
    assert steps.param_shapes(get_config("tinyllama-1.1b"),
                              compute_dtype=False)["embed"].dtype == torch.float32
