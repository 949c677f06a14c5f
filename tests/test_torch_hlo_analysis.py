"""The port's step analysis (``repro_torch.launch.hlo_analysis`` and
``steps.trace_cell``), held to exact counts as the reference's
``tests/test_hlo_analysis.py`` holds its HLO analysis: the depth
extrapolation and the 16-row block multipliers equal a full unrolled
trace, products count 2 M N K, a copy of a slice of a stacked leaf
charges the slice, each collective kind is counted with its operand and
wire bytes on a fake 8-rank world, and the roofline picks its dominant
term from the H100 constants.
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import collectives
from repro_torch.distributed.partitioner import MeshShape
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import steps
from repro_torch.models.config import ShapeConfig

ONE = MeshShape(("data", "model"), (1, 1))
MESH = MeshShape(("data", "model"), (2, 4))
KINDS = ("train", "prefill", "decode")


def _shape(kind: str, seq: int = 64) -> ShapeConfig:
    return ShapeConfig(kind[0], seq, 4, kind)


def _exact(a: H.Trace, b: H.Trace, peak_rtol: float = 0.01) -> None:
    fa, fb = a.fields(), b.fields()
    for k in fa:
        if k == "peak_bytes" or k.startswith("peak/"):
            assert fa[k] == pytest.approx(fb[k], rel=peak_rtol), k
        else:
            assert fa[k] == fb[k], (k, fa[k], fb[k])


def _trace(fn, *args) -> H.Trace:
    an = H.StepAnalysis()
    with H.analysing(an):
        fn(*args)
    return an.finish()


# -- counterparts of tests/test_hlo_analysis.py -------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_depth_extrapolation_equals_the_full_depth_trace(kind):
    """One and two repeats extrapolated to four == all four traced
    (the reference's scan == unrolled)."""
    cfg = dataclasses.replace(get_smoke_config("tinyllama-1.1b"), n_layers=4)
    ext = steps.trace_cell(cfg, _shape(kind), ONE)
    full = steps.trace_cell(cfg, _shape(kind), ONE, full_depth=True)
    assert float(ext.flops) > 0
    _exact(ext, full)


@pytest.mark.parametrize("arch,kind", [("jamba-1.5-large-398b", "train"),
                                       ("jamba-1.5-large-398b", "prefill"),
                                       ("seamless-m4t-large-v2", "prefill")])
def test_nested_pattern_extrapolation(arch, kind):
    """jamba's period of four layers (attention, Mamba, MoE slots) at
    three repeats, and an enc-dec's two stacks, extrapolated == traced."""
    cfg = get_smoke_config(arch)
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, n_layers=3, n_encoder_layers=4)
    else:
        cfg = dataclasses.replace(cfg, n_layers=3 * len(cfg.pattern), remat=False)
    ext = steps.trace_cell(cfg, _shape(kind), ONE)
    full = steps.trace_cell(cfg, _shape(kind), ONE, full_depth=True)
    _exact(ext, full)


def test_batched_product_flops():
    a = torch.empty((4, 16, 32), device="meta")
    b = torch.empty((4, 32, 8), device="meta")
    t = _trace(lambda: torch.einsum("bik,bkj->bij", a, b))
    assert t.flops == 2 * 4 * 16 * 8 * 32
    # elementwise work and convolutions are not products
    x = torch.empty((1, 4, 64), device="meta")
    w = torch.empty((4, 1, 3), device="meta")
    t = _trace(lambda: torch.nn.functional.conv1d(torch.tanh(x), w, groups=4))
    assert t.flops == 0


def test_slice_of_a_stacked_leaf_is_charged_at_the_slice():
    """A pass over one (128, 128) slice per step of a (64, 128, 128)
    stack reads the stack once, not 64 times."""
    ws = torch.empty((64, 128, 128), device="meta")
    x = torch.empty((1, 128), device="meta")

    def f():
        h = x
        for i in range(64):
            h = h @ ws[i]
        return h

    t = _trace(f)
    stack = 64 * 128 * 128 * 4
    assert 0.9 * stack < t.bytes < 3 * stack
    assert t.flops == 64 * 2 * 128 * 128
    # a copy of a slice charges the slice (read + write), a view nothing
    t = _trace(lambda: (ws[3].clone(), ws[5].t()))
    assert t.bytes == 2 * 128 * 128 * 4 and t.bytes_raw == t.bytes


def test_collectives_on_a_fake_eight_rank_world():
    """Each kind on the port's own collectives (``distributed/
    collectives.py``): count, operand bytes, and wire bytes with the
    all-reduce at 2x; a point-to-point ring shift is a collective-permute
    counted once, on its send."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        x = torch.zeros((16, 128))
        n = 16 * 128 * 4
        an = H.StepAnalysis(device="cpu")  # gloo-style host tensors: a send needs a device
        with H.analysing(an):
            collectives.all_reduce_sum(x)
            collectives.all_gather_dim(x)
            collectives.reduce_scatter_mean(x)
            collectives.all_to_all(torch.zeros((8, 128)))
            collectives.ppermute_shift(x, shift=1)
            collectives.all_reduce_sum(x)
        rec = H.analyze_trace(an.finish(), 8)
    finally:
        dist.destroy_process_group()
    pk = rec["collectives"]["per_kind"]
    assert pk["all-reduce"] == {"count": 2, "operand_bytes": 2 * n, "wire_bytes": 4 * n}
    assert pk["all-gather"] == {"count": 1, "operand_bytes": n, "wire_bytes": n}
    assert pk["reduce-scatter"] == {"count": 1, "operand_bytes": n, "wire_bytes": n}
    assert pk["all-to-all"] == {"count": 1, "operand_bytes": 8 * 128 * 4,
                                "wire_bytes": 8 * 128 * 4}
    assert pk["collective-permute"] == {"count": 1, "operand_bytes": n, "wire_bytes": n}
    assert rec["collectives"]["operand_bytes"] == 5 * n + 8 * 128 * 4
    assert rec["collectives"]["wire_bytes"] == 7 * n + 8 * 128 * 4


def test_roofline_terms_dominance():
    t = H.roofline_terms(H.PEAK_FLOPS, 100e9, 1e9)
    assert t["compute_s"] == 1.0 and t["dominant"] == "compute"
    t = H.roofline_terms(1e12, H.HBM_BW * 2, 1e9)
    assert t["memory_s"] == 2.0 and t["dominant"] == "memory"
    t = H.roofline_terms(1e12, 1e9, H.NVLINK_BW * 3)
    assert t["collective_s"] == 3.0 and t["dominant"] == "collective"
    assert (H.PEAK_FLOPS, H.HBM_BW, H.NVLINK_BW) == (989e12, 3.35e12, 450e9)


# -- the 16-row block loops ----------------------------------------------------

# remat off where a layer's last product is a blocked one (a Mamba
# out-projection): torch's checkpoint stops its recomputation early, inside
# that loop of the unrolled run (see the next test)
BLOCK_CASES = [(a, k, True) for a in ("tinyllama-1.1b", "qwen3-moe-235b-a22b",
                                      "seamless-m4t-large-v2", "internvl2-1b") for k in KINDS]
BLOCK_CASES += [(a, k, k != "train") for a in ("mamba2-2.7b", "jamba-1.5-large-398b")
                for k in KINDS]


@pytest.mark.parametrize("arch,kind,remat", BLOCK_CASES)
def test_block_multiplier_equals_the_unrolled_loops(arch, kind, remat):
    """One 16-row block times its trip count (the rest as uncounted
    empties) == every block traced: FLOPs, both byte counts and every
    collective exactly, the peak within 1%."""
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    multiplied = steps.trace_cell(cfg, _shape(kind), ONE)
    unrolled = steps.trace_cell(cfg, _shape(kind), ONE, unroll_blocks=True)
    assert float(multiplied.flops) > 0
    _exact(multiplied, unrolled)


def test_early_stopped_recompute_inside_a_blocked_product():
    """Under remat, torch's checkpoint stops the recomputation once the
    last saved tensor is back: in a Mamba layer that is the last block's
    input of the out-projection, so the unrolled run recomputes all blocks
    but that one, and the multiplied trace (like the reference's XLA,
    which drops the unused product) none: n - 1 blocks of it per layer."""
    cfg = get_smoke_config("mamba2-2.7b")
    multiplied = steps.trace_cell(cfg, _shape("train"), ONE)
    unrolled = steps.trace_cell(cfg, _shape("train"), ONE, unroll_blocks=True)
    rows = 4 * 64
    n = rows // 16
    out_proj = 2 * rows * cfg.d_inner * cfg.d_model
    assert unrolled.flops - multiplied.flops == cfg.n_layers * out_proj * (n - 1) // n


def test_block_padding_is_counted_apart():
    """A decode tick of 4 lanes runs its row-blocked products on 16-row
    blocks: the 12 padding rows are counted as ``row_pad_flops``, not as
    the step's FLOPs."""
    cfg = get_smoke_config("tinyllama-1.1b")
    t = steps.trace_cell(cfg, _shape("decode"), ONE)
    # the head: 4 real rows of 16 (its GEMM is row-blocked, the projections are not)
    head = 2 * 4 * cfg.d_model * cfg.padded_vocab
    assert t.row_pad_flops >= 3 * head
    assert float(t.flops) == 819200.0  # the reference's count of this cell


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_trace_multiplier_equals_unrolled(kind):
    """On a 2 x 4 mesh the row helpers run each rank's rows as one call:
    the same counts whether or not the analysis unrolls, and the
    per-rank FLOPs are the one-rank trace's over 8 where every product
    splits (tinyllama smoke: heads and FFN over 4, batch over 2)."""
    cfg = get_smoke_config("tinyllama-1.1b")
    a = steps.trace_cell(cfg, _shape(kind), MESH)
    b = steps.trace_cell(cfg, _shape(kind), MESH, unroll_blocks=True)
    _exact(a, b)
    one = steps.trace_cell(cfg, _shape(kind), ONE)
    assert a.flops == one.flops / 8
    assert sum(v["count"] for v in a.coll.values()) > 0


def test_the_fake_mesh_is_a_cuda_one_on_any_host():
    """The shards are meta and the mesh a CUDA one whether or not this
    process has a card: DTensor moves a shard from one dim to another by
    one all-to-all, as over NCCL (not by gloo's all-gather and chunk), and
    the analysis counts it, operand the rank's shard; the group is gone
    after."""
    from torch.distributed.tensor import DTensor, Shard

    with steps.fake_world(MeshShape(("model",), (8,))) as mesh:
        assert mesh.device_type == "cuda"
        x = DTensor.from_local(torch.empty((16, 64), device="meta"), mesh, [Shard(0)],
                               run_check=False, shape=torch.Size((128, 64)),
                               stride=(64, 1))
        an = H.StepAnalysis()
        with H.analysing(an):
            x.redistribute(mesh, [Shard(1)])
        coll = an.finish().coll
    assert not dist.is_initialized()
    assert coll["all-to-all"] == {"count": 1, "operand_bytes": 16 * 64 * 4}
    assert all(v["count"] == 0 for k, v in coll.items() if k != "all-to-all")


def test_kernel_configs_are_refused_by_name():
    cfg = dataclasses.replace(get_smoke_config("tinyllama-1.1b"), attn_impl="pallas")
    with pytest.raises(H.KernelInTrace, match="flash_attention"):
        steps.trace_cell(cfg, _shape("prefill"), ONE)
    cfg = dataclasses.replace(get_smoke_config("tinyllama-1.1b"), quant="bnn",
                              bnn_engine="packed")
    with pytest.raises(H.KernelInTrace, match="fused_bnn_matmul"):
        steps.trace_cell(cfg, _shape("prefill"), ONE)


def test_row_helpers_outside_an_analysis_pay_one_check():
    from repro_torch.kernels import rows

    assert rows.ACTIVE is None
    an = H.StepAnalysis()
    with H.analysing(an):
        assert rows.ACTIVE is an
    assert rows.ACTIVE is None
