"""The port's traced step on a (2, 4) mesh against the reference's
compiled one: the smoke configs of six architectures, train / prefill /
decode of 64 x 4, the port traced on a fake 8-rank world (DTensors of
``meta`` shards), the reference lowered and compiled in a subprocess
with 8 forced host devices (as ``tests/test_multidevice.py`` does).
Per-device FLOPs within 5%; collectives and peak memory printed side by
side (not gated: ROADMAP queue 3 holds the ratios above 2x).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.partitioner import MeshShape
from repro_torch.launch import hlo_analysis
from repro_torch.launch.steps import trace_cell
from repro_torch.models.config import ShapeConfig

ROOT = Path(__file__).parent.parent
ARCHS = ("tinyllama-1.1b", "qwen3-moe-235b-a22b", "mamba2-2.7b", "seamless-m4t-large-v2",
         "internvl2-1b", "jamba-1.5-large-398b")
KINDS = ("train", "prefill", "decode")

REFERENCE = textwrap.dedent("""
    import json
    from repro.configs import get_smoke_config
    from repro.launch import hlo_analysis
    from repro.launch.mesh import make_test_mesh
    from repro.launch.steps import lower_cell
    from repro.models.config import ShapeConfig

    mesh = make_test_mesh((2, 4), ("data", "model"))
    out = {}
    for arch in %r:
        for kind in %r:
            rec = hlo_analysis.analyze_compiled(
                lower_cell(get_smoke_config(arch), ShapeConfig(kind, 64, 4, kind), mesh).compile(),
                mesh.size)
            out[arch + "/" + kind] = {
                "flops_per_dev": rec["flops_per_dev"],
                "coll": rec["collectives"]["operand_bytes"],
                "peak": rec["memory"]["peak_per_device_bytes"]}
    print("REFERENCE " + json.dumps(out))
""" % (ARCHS, KINDS))


@pytest.fixture(scope="module")
def reference():
    """The reference's records, compiled in a subprocess that runs while
    the port's cells are traced."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    box = {}

    def get():
        if "recs" not in box:
            out, err = proc.communicate(timeout=480)
            assert proc.returncode == 0, err[-3000:]
            line = next(ln for ln in out.splitlines() if ln.startswith("REFERENCE "))
            box["recs"] = json.loads(line[len("REFERENCE "):])
        return box["recs"]

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.mark.parametrize("arch", ARCHS)
def test_traced_flops_match_the_reference_on_a_2x4_mesh(arch, reference, capsys):
    cfg = get_smoke_config(arch)
    mesh = MeshShape(("data", "model"), (2, 4))
    got = {}
    for kind in KINDS:
        got[kind] = hlo_analysis.analyze_trace(
            trace_cell(cfg, ShapeConfig(kind, 64, 4, kind), mesh), mesh.size)
    refs = reference()
    for kind in KINDS:
        ref, rec = refs[f"{arch}/{kind}"], got[kind]
        with capsys.disabled():
            print(f"\n{arch} {kind} (2, 4): flops/dev {rec['flops_per_dev']:.6e} vs "
                  f"{ref['flops_per_dev']:.6e}; collective operand bytes "
                  f"{rec['collectives']['operand_bytes']:.4g} vs {ref['coll']:.4g}; peak "
                  f"{rec['memory']['peak_per_device_bytes']} vs {ref['peak']} B")
        assert rec["flops_per_dev"] == pytest.approx(ref["flops_per_dev"], rel=0.05), (arch, kind)
