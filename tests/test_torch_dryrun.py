"""The port's spec-level dry-run (``repro_torch.launch.dryrun``): every
architecture x shape x production mesh runs (or is skipped by the
reference's rule) with no spec violation and nothing allocated, and a
cell's per-rank bytes equal those the JAX package's specs give its own
argument shapes (each leaf's bytes over the product of the mesh axes its
spec names); the CLI caches each record under ``--out``. An
architecture the JAX package lacks is held to the port's own counts.
"""

import json
import math
import types

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.data import make_input_specs as jax_input_specs
from repro.distributed import partitioner as jpart
from repro.launch import steps as jsteps
from repro.models.config import SHAPES as JSHAPES
from repro_torch import tree as tree_lib
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun, steps
from repro_torch.models.config import SHAPES, shape_applicable


def jax_bytes(tree, specs, sizes) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves, strict=True):
        n = math.prod(sizes[a] for e in spec if e is not None
                      for a in ((e,) if isinstance(e, str) else e))
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // n
    return total


def _port_only_cells(arch):
    """An architecture the JAX package lacks (granite-4.0-h-small): every
    cell validates, and its numbers are the port's own: the model FLOPs
    from its active parameters, each rank's parameter bytes between an
    even split of the whole tree and the whole, the parts summing to the
    total."""
    cfg = get_config(arch)
    whole = sum(math.prod(t.shape) * t.element_size()
                for _, t in tree_lib.leaves_with_paths(steps.param_shapes(cfg)))
    for multi_pod in (False, True):
        for name, shape in SHAPES.items():
            rec = dryrun.cell_specs(arch, name, multi_pod=multi_pod)
            runs, _ = shape_applicable(cfg, shape)
            assert runs == (rec["status"] != "skipped") and cfg.sub_quadratic
            assert rec["status"] == "ok" and rec["violations"] == [], rec
            assert rec["n_chips"] == (512 if multi_pod else 256)
            factor = 6 if shape.kind == "train" else 2
            assert rec["model_flops"] == factor * cfg.active_param_count() * rec["tokens"]
            got = rec["spec_bytes_per_device"]
            assert whole / rec["n_chips"] <= got["params"] < whole
            assert got["total"] == sum(v for k, v in got.items() if k != "total")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_cell_validates_and_counts_the_reference_bytes(arch):
    if arch not in JAX_ARCH_IDS:
        _port_only_cells(arch)
        return
    for multi_pod in (False, True):
        names, sizes = ((("pod", "data", "model"), (2, 16, 16)) if multi_pod
                        else (("data", "model"), (16, 16)))
        jm = types.SimpleNamespace(shape=dict(zip(names, sizes)), axis_names=names)
        for name, shape in SHAPES.items():
            rec = dryrun.cell_specs(arch, name, multi_pod=multi_pod)
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
    # the traced step's analysis, the reference's record keys
    for key in ("flops_per_dev", "bytes_per_dev", "bytes_raw_per_dev", "collectives", "memory",
                "roofline", "useful_flop_ratio", "spec_bytes_per_device"):
        assert key in rec, key
    assert rec["flops"] == rec["flops_per_dev"] * 256 > rec["model_flops"]
    assert rec["memory"]["peak_per_device_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["collectives"]["operand_bytes"] > 0 and 0 < rec["trace_s"] <= 120
    skipped = json.loads((tmp_path / "tinyllama-1.1b__long_500k__sp.json").read_text())
    assert skipped["status"] == "skipped"
    assert dryrun.main(args) == 0
    assert capsys.readouterr().out.count(": cached") == 2


# -- the traced step (steps.trace_cell + launch/hlo_analysis) against the
# -- reference's compiled analysis -------------------------------------------

PARITY_ARCHS = ("tinyllama-1.1b", "qwen3-moe-235b-a22b", "mamba2-2.7b",
                "seamless-m4t-large-v2", "internvl2-1b", "jamba-1.5-large-398b")
PARITY_KINDS = ("train", "prefill", "decode")


def reference_only_flops(cfg, shape) -> int:
    """Products the reference's compiled step runs and the port's does
    not, by name (ROADMAP queue 3):

    * train: each attention chunk's scores recomputed in the backward
      (the reference checkpoints every chunk step, ``layers.py``
      ``@jax.checkpoint def step``; the port keeps the chunk's
      probabilities), one (Sq x C x D) product per chunk per attention
      layer; in a hybrid stack (jamba) XLA's layer replay also recomputes
      each dense FFN's ``w2``, which torch's checkpoint stops before (its
      output is not needed by the backward);
    * decode: a Mamba conv step's taps, ``einsum("bkc,kc->bc")``, a dot
      in the reference and an elementwise sum over K in the port.
    """
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        def scores(sq, skv):
            c = cfg.attn_chunk
            return 2 * b * cfg.n_heads * sq * math.ceil(skv / c) * c * cfg.hd
        if cfg.is_encdec:
            src = cfg.frontend_len
            return (cfg.n_encoder_layers * scores(src, src)
                    + cfg.n_layers * (scores(s, s) + scores(s, src)))
        rows = s + (cfg.frontend_len if cfg.frontend == "vision" else 0)
        attn = cfg.n_repeats * sum(k.mixer == "attn" for k in cfg.pattern)
        out = attn * scores(rows, rows)
        if len({k.mixer for k in cfg.pattern}) > 1:  # hybrid: the dense w2 replay
            dense = cfg.n_repeats * sum(not k.moe for k in cfg.pattern)
            out += dense * 2 * b * s * cfg.d_ff * cfg.d_model
        return out
    if shape.kind == "decode":
        mamba = cfg.n_repeats * sum(k.mixer == "mamba" for k in cfg.pattern)
        gn = cfg.ssm_groups * cfg.ssm_state
        return mamba * 2 * b * cfg.ssm_conv * (cfg.d_inner + 2 * gn)
    return 0


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_traced_flops_match_the_reference_on_one_device(arch, capsys):
    """One device, the smoke config, 64 x 4: the port's traced
    ``flops_per_dev`` within 1% of the reference's
    ``analyze_compiled(lower_cell(...).compile(), 1)`` less its named
    products. Collective and peak bytes printed beside the reference's."""
    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch import hlo_analysis as jh
    from repro.launch.mesh import make_test_mesh
    from repro.models.config import ShapeConfig as JShape
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.partitioner import MeshShape
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch.steps import trace_cell
    from repro_torch.models.config import ShapeConfig

    jm = make_test_mesh((1, 1), ("data", "model"))
    cfg = get_smoke_config(arch)
    for kind in PARITY_KINDS:
        ref = jh.analyze_compiled(jsteps.lower_cell(jax_smoke(arch), JShape(kind, 64, 4, kind),
                                                    jm).compile(), 1)
        shape = ShapeConfig(kind, 64, 4, kind)
        got = hlo_analysis.analyze_trace(
            trace_cell(cfg, shape, MeshShape(("data", "model"), (1, 1))), 1)
        want = ref["flops_per_dev"] - reference_only_flops(cfg, shape)
        with capsys.disabled():
            print(f"\n{arch} {kind} (1, 1): flops {got['flops_per_dev']:.6e} vs "
                  f"{ref['flops_per_dev']:.6e} (less named {want:.6e}); peak "
                  f"{got['memory']['peak_per_device_bytes']} vs "
                  f"{ref['memory']['peak_per_device_bytes']} B")
        assert got["flops_per_dev"] == pytest.approx(want, rel=0.01), (arch, kind)
