"""The launch plan and variant choice of the bitlinear / WDM MMM kernels
(``repro_torch.kernels.mma_plan``), checked on the CPU: the plan is
computed in Python so that these can run without a card."""

import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build, mma_plan

ROOT = Path(__file__).resolve().parents[1]

# the tinyllama-1.1b projection shapes chip_smoke.py times (m, n)
MMA_SHAPES = {"w_qkv": (2048, 2560), "w1/w3": (2048, 5632), "w2": (5632, 2048)}
# (x itemsize, binarize): the MMM, bitlinear on bf16 x, bitlinear on fp32 x
KINDS = {"mmm": (2, False), "bitlinear-bf16": (2, True), "bitlinear-f32": (4, True)}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("rows", [8, 128])
@pytest.mark.parametrize("shape", list(MMA_SHAPES))
def test_plan_fills_the_card(shape, rows, kind):
    m, n = MMA_SHAPES[shape]
    x_size, sign = KINDS[kind]
    plan = mma_plan.sm90_plan(rows, m, n, x_size, sign)
    kt = -(-m // mma_plan.BK)
    assert plan.variant == "sm90"
    assert plan.ctas >= 128
    assert 1 <= plan.split <= mma_plan.MAX_SPLIT
    kt_per = -(-kt // plan.split)
    assert (plan.split - 1) * kt_per < kt  # every split holds at least one k tile
    assert plan.row_tile in mma_plan.ROW_TILES and plan.row_tile >= min(rows, 128)
    assert plan.grid == (plan.split, -(-n // mma_plan.BN), -(-rows // plan.row_tile))
    assert 2 <= plan.stages <= mma_plan.MAX_STAGES
    assert plan.smem == mma_plan.smem_bytes(plan.row_tile, x_size, sign, plan.stages)
    assert plan.smem <= mma_plan.MAX_SMEM


@pytest.mark.parametrize("rows,m,n", [(1, 64, 8), (3, 100 * 8, 24), (8, 2056, 264),
                                      (200, 512, 256), (129, 5632, 2048), (8, 64 * 9, 128)])
def test_plan_invariants_off_the_main_shapes(rows, m, n):
    for x_size, sign in KINDS.values():
        plan = mma_plan.sm90_plan(rows, m, n, x_size, sign)
        kt = -(-m // mma_plan.BK)
        assert 1 <= plan.split <= min(mma_plan.MAX_SPLIT, kt)
        assert (plan.split - 1) * -(-kt // plan.split) < kt
        assert plan.grid[2] * plan.row_tile >= rows
        assert plan.smem <= mma_plan.MAX_SMEM


def test_two_ctas_per_sm_where_three_stages_fit():
    """A plan keeps two CTAs per SM whenever a ring of three stages fits
    in half the SM's shared memory, and otherwise takes the deepest ring
    one CTA can hold."""
    for rows in (8, 32, 128):
        for x_size, sign in KINDS.values():
            plan = mma_plan.sm90_plan(rows, 2048, 5632, x_size, sign)
            three = mma_plan.smem_bytes(plan.row_tile, x_size, sign, 3)
            if three <= mma_plan.TWO_PER_SM_SMEM:
                assert plan.stages >= 3 and plan.smem <= mma_plan.TWO_PER_SM_SMEM
            else:
                more = mma_plan.smem_bytes(plan.row_tile, x_size, sign, plan.stages + 1)
                assert plan.stages == mma_plan.MAX_STAGES or more > mma_plan.MAX_SMEM


def test_constants_mirror_the_header():
    text = (_build.SRC_DIR / "sm90_mma.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kBN") == mma_plan.BN
    assert const("kBK") == mma_plan.BK
    assert const("kMaxSplit") == mma_plan.MAX_SPLIT
    assert const("kMaxSmem") == mma_plan.MAX_SMEM
    assert re.search(r"constexpr int kPitch = kBN \+ (\d+);", text).group(1) == str(
        mma_plan.PITCH - mma_plan.BN)
    assert re.search(r"kVariantWmma = (\d+)", text).group(1) == str(mma_plan.VARIANTS["wmma"])
    assert re.search(r"kVariantSm90 = (\d+)", text).group(1) == str(mma_plan.VARIANTS["sm90"])


def _aligned(shape, dtype, offset=0):
    """A CPU tensor of ``shape`` whose data starts ``offset`` elements past
    a 64-byte boundary."""
    numel = 1
    for s in shape:
        numel *= s
    base = torch.zeros(numel + 64, dtype=dtype)
    skip = (-base.data_ptr() % 64) // base.element_size() + offset
    return base[skip: skip + numel].view(shape)


@pytest.fixture
def sms(monkeypatch):
    monkeypatch.setattr(mma_plan, "_sm_count", lambda device: mma_plan.H100_SMS)


@pytest.mark.parametrize("rows,m,n,xdtype,variant", [
    (8, 2048, 5632, torch.bfloat16, "sm90"),
    (8, 2056, 264, torch.bfloat16, "sm90"),  # m past the last 64-feature k tile
    (3, 260, 16, torch.float32, "sm90"),  # fp32 rows of 1040 bytes
    (9, 513, 3, torch.bfloat16, "wmma"),  # n % 8 != 0
    (4, 64, 12, torch.bfloat16, "wmma"),  # w rows of 24 bytes
    (4, 36, 16, torch.bfloat16, "wmma"),  # bf16 x rows of 72 bytes
    (4, 34, 16, torch.float32, "wmma"),  # fp32 x rows of 136 bytes
])
def test_variant_by_shape(sms, rows, m, n, xdtype, variant):
    x = _aligned((rows, m), xdtype)
    w = _aligned((m, n), torch.bfloat16)
    out = _aligned((rows, n), torch.float32)
    alpha = _aligned((n,), torch.float32)
    assert mma_plan.choose(x, w, out, alpha).variant == variant
    assert mma_plan.choose(x.to(torch.bfloat16), w, out).variant == (
        "sm90" if n % 8 == 0 and m % 8 == 0 else "wmma")


@pytest.mark.parametrize("which", ["x", "w", "out", "alpha"])
def test_misaligned_pointer_takes_wmma(sms, which):
    """A base that is not 16-byte aligned (a view at an odd element) takes
    the WMMA variant, whatever the shape."""
    rows, m, n = 8, 256, 128
    t = {
        "x": _aligned((rows, m), torch.bfloat16, offset=1 if which == "x" else 0),
        "w": _aligned((m, n), torch.bfloat16, offset=1 if which == "w" else 0),
        "out": _aligned((rows, n), torch.float32, offset=1 if which == "out" else 0),
        "alpha": _aligned((n,), torch.float32, offset=1 if which == "alpha" else 0),
    }
    assert mma_plan.choose(t["x"], t["w"], t["out"], t["alpha"]).variant == "wmma"
    aligned = {k: _aligned(v.shape, v.dtype) for k, v in t.items()}
    assert mma_plan.choose(aligned["x"], aligned["w"], aligned["out"],
                           aligned["alpha"]).variant == "sm90"


def test_plan_args_are_what_the_c_entry_takes():
    plan = mma_plan.sm90_plan(128, 2048, 5632, 2, True)
    assert plan.args == (1, 128, plan.split, plan.stages)
    assert mma_plan.wmma_plan(9, 3).args[0] == 0
    assert "CTAs" in plan.describe() and "wmma" in mma_plan.wmma_plan(9, 3).describe()
