"""The port's spec-level dry-run (``repro_torch.launch.dryrun``): every
architecture x shape x production mesh runs (or is skipped by the
reference's rule) with no spec violation and nothing allocated, and a
cell's per-rank bytes equal those the JAX package's specs give its own
argument shapes (each leaf's bytes over the product of the mesh axes its
spec names); the CLI caches each record under ``--out``.
"""

import json
import math
import types

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_config
from repro.data import make_input_specs as jax_input_specs
from repro.distributed import partitioner as jpart
from repro.launch import steps as jsteps
from repro.models.config import SHAPES as JSHAPES
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES


def jax_bytes(tree, specs, sizes) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves, strict=True):
        n = math.prod(sizes[a] for e in spec if e is not None
                      for a in ((e,) if isinstance(e, str) else e))
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // n
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_cell_validates_and_counts_the_reference_bytes(arch):
    for multi_pod in (False, True):
        names, sizes = ((("pod", "data", "model"), (2, 16, 16)) if multi_pod
                        else (("data", "model"), (16, 16)))
        jm = types.SimpleNamespace(shape=dict(zip(names, sizes)), axis_names=names)
        for name, shape in SHAPES.items():
            rec = dryrun.run_cell(arch, name, multi_pod=multi_pod)
            if rec["status"] == "skipped":
                assert name == "long_500k" and not jax_config(arch).sub_quadratic
                continue
            assert rec["status"] == "ok" and rec["violations"] == [], rec
            assert rec["n_chips"] == math.prod(sizes)
            jcfg = jax_config(arch)
            factor = 6 if shape.kind == "train" else 2
            assert rec["tokens"] == (shape.global_batch if shape.kind == "decode"
                                     else shape.global_batch * shape.seq_len)
            assert rec["model_flops"] == factor * jcfg.active_param_count() * rec["tokens"]
            p_sds = jsteps.param_shapes(jcfg)
            fsdp = shape.kind == "train" and jsteps.train_wants_fsdp(jcfg, JSHAPES[name], jm)
            assert rec["fsdp"] == fsdp
            p_spec = jpart.infer_specs(p_sds, jm, fsdp=fsdp)
            got = rec["spec_bytes_per_device"]
            assert got["params"] == jax_bytes(p_sds, p_spec, jm.shape)
            j_in = jax_input_specs(jcfg, JSHAPES[name])
            if shape.kind == "train":
                o_sds = jsteps.opt_shapes(p_sds, jsteps.default_opt_cfg(jcfg))
                assert got["opt_state"] == jax_bytes(o_sds, jpart.opt_state_specs(p_spec, o_sds),
                                                     jm.shape)
                assert got["batch"] == jax_bytes(j_in, jpart.batch_specs(j_in, jm, fsdp=fsdp),
                                                 jm.shape)
            elif shape.kind == "decode":
                assert got["caches"] == jax_bytes(
                    j_in["caches"], jpart.cache_specs(j_in["caches"], jm), jm.shape)
            assert got["total"] == sum(v for k, v in got.items() if k != "total")


def test_cli_writes_and_reuses_records(tmp_path, capsys):
    args = ["--arch", "tinyllama-1.1b", "--shape", "train_4k", "--shape", "long_500k",
            "--single-pod", "--out", str(tmp_path)]
    assert dryrun.main(args) == 0
    rec = json.loads((tmp_path / "tinyllama-1.1b__train_4k__sp.json").read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    skipped = json.loads((tmp_path / "tinyllama-1.1b__long_500k__sp.json").read_text())
    assert skipped["status"] == "skipped"
    assert dryrun.main(args) == 0
    assert capsys.readouterr().out.count(": cached") == 2
