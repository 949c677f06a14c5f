"""The variant choice and launch plan of the flash-attention and Hamming
kernels, and the exact identities their tensor-core variants rest on,
checked on the CPU (the choice is made in Python, before the launch, from
dtypes, shapes, strides and pointers alone)."""

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, mma_plan, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import xnor_matmul

# tinyllama-1.1b's packed projections (words, n) and the row counts
# chip_smoke.py times: a decode tick of 8 slots, one 128-token prompt, the
# lockstep prefill of 8 x 128 tokens
HAM_SHAPES = {"q/o": (64, 2048), "k/v": (64, 256), "w1/w3": (64, 5632), "w2": (176, 2048)}
HAM_ROWS = (8, 128, 1024)


def _aligned(shape, dtype, offset=0):
    """A CPU tensor of ``shape`` whose data starts ``offset`` elements past
    a 64-byte boundary."""
    numel = int(np.prod(shape))
    base = torch.zeros(numel + 64, dtype=dtype)
    skip = (-base.data_ptr() % 64) // base.element_size() + offset
    return base[skip: skip + numel].view(shape)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _bshd_view(b, s, h, d, dtype=torch.bfloat16, offset=0):
    """(B, H, S, D) as the model passes it: a transpose(1, 2) view of a
    contiguous (B, S, H, D) activation."""
    return _aligned((b, s, h, d), dtype, offset).transpose(1, 2)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_bf16_views_take_sm90(d):
    q = _bshd_view(2, 40, 8, d)
    kv = _bshd_view(2, 72, 2, d)
    assert fa.choose_variant(q, kv, kv) == "sm90"
    c = _aligned((2, 8, 40, d), torch.bfloat16)  # contiguous (B, H, S, D)
    assert fa.choose_variant(c, kv, kv) == "sm90"


@pytest.mark.parametrize("case", ["fp32", "head dim 32", "row stride of 68", "odd base", "q",
                                  "k", "v"])
def test_flash_other_operands_take_fma(case):
    d = 32 if case == "head dim 32" else 64
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    t = {n: _bshd_view(1, 24, 4, d, dtype) for n in "qkv"}
    if case == "row stride of 68":  # heads padded to 68 features, cut to 64
        t["q"] = _aligned((1, 24, 4, 68), dtype)[..., :64].transpose(1, 2)
    elif case == "odd base":
        t["k"] = _bshd_view(1, 24, 4, d, dtype, offset=1)
    elif case in "qkv":  # one operand at a base 8 bytes past a 16-byte boundary
        t[case] = _bshd_view(1, 24, 4, d, dtype, offset=4)
    assert fa.choose_variant(t["q"], t["k"], t["v"]) == "fma"


def test_flash_key_tile_mirrors_the_kernel():
    text = (_build.SRC_DIR / "flash_attention.cu").read_text()
    assert int(re.search(r"constexpr int kBKeys = (\d+);", text).group(1)) == fa.KEY_TILE
    assert "flash_attention_sm90" in text and fa.VARIANTS == ("fma", "sm90")


@pytest.mark.parametrize("kind", ["uniform", "zero", "one", "tiny"])
def test_three_term_split_is_exact(kind):
    """p == hi + mid + lo exactly, each term a bf16 value, for the p of the
    online softmax (in [0, 1]); tiny values stay exact down to 2^-110."""
    rng = np.random.default_rng(7)
    p = {
        "uniform": rng.random(200_000),
        "zero": np.zeros(16),
        "one": np.ones(16),
        "tiny": np.concatenate([2.0 ** -rng.uniform(20, 110, size=20_000), [1e-30, 2.0**-110]]),
    }[kind]
    p = torch.from_numpy(p.astype(np.float32))
    hi, mid, lo = fa.split_bf16x3(p)
    for term in (hi, mid, lo):
        assert torch.equal(term.to(torch.bfloat16).to(torch.float32), term)
    assert torch.equal(hi + mid + lo, p)
    assert torch.equal((hi.double() + mid.double() + lo.double()).float(), p)
    # a single bf16 term would not be exact
    if kind == "uniform":
        assert not torch.equal(hi, p)


# ---------------------------------------------------------------------------
# the Hamming matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", HAM_ROWS)
@pytest.mark.parametrize("shape", list(HAM_SHAPES))
def test_hamming_plan_fills_the_card(shape, rows):
    kw, n = HAM_SHAPES[shape]
    plan = mma_plan.hamming_plan(rows, kw, n)
    kt = -(-kw // mma_plan.HAM_BKW)
    tiles = -(-n // mma_plan.HAM_BN) * -(-rows // plan.row_tile)
    assert plan.variant == "b1"
    assert 1 <= plan.split <= mma_plan.MAX_SPLIT
    assert (plan.split - 1) * -(-kt // plan.split) < kt  # every split holds a k stage
    if tiles * min(mma_plan.MAX_SPLIT, kt) >= 128:  # where K allows
        assert plan.ctas >= 128
    assert plan.grid == (plan.split, -(-n // mma_plan.HAM_BN), -(-rows // plan.row_tile))
    assert plan.row_tile in mma_plan.HAM_ROW_TILES and plan.row_tile <= max(8, rows)
    # a smaller row tile before a split: only a row tile of 8, or one that
    # already gives the card's SMs their tiles, is split
    sms = mma_plan.H100_SMS
    assert plan.split == 1 or plan.row_tile == 8 or tiles >= sms
    if plan.row_tile < min(64, rows):  # halved only while short of tiles
        assert -(-n // mma_plan.HAM_BN) * -(-rows // (2 * plan.row_tile)) < sms
    assert 2 <= plan.stages <= mma_plan.HAM_MAX_STAGES
    assert plan.smem == mma_plan.hamming_smem_bytes(plan.row_tile, plan.stages)
    assert plan.smem <= mma_plan.MAX_SMEM


def test_hamming_decode_shapes_reach_128_ctas():
    """At 8 rows every projection but k/v (two 128-column tiles, 8 k
    stages: 16 CTAs at most) gets >= 128 CTAs."""
    for shape, (kw, n) in HAM_SHAPES.items():
        ctas = mma_plan.hamming_plan(8, kw, n).ctas
        assert ctas == 16 if shape == "k/v" else ctas >= 128, shape


def _ham_operands(rows, m, n, prepad, offset=0):
    w = ops.pack_weights(torch.ones((m, n)))
    if prepad:
        w = ops.pad_packed_weights(w)
    wa = _aligned(tuple(w.shape), torch.int32)
    a = _aligned((rows, -(-m // 32)), torch.int32, offset)
    return a, wa, _aligned((rows, n), torch.int32)


@pytest.mark.parametrize("rows,m,n,prepad,variant", [
    (8, 2048, 5632, False, "b1"),
    (1024, 5632, 2048, False, "b1"),
    (3, 100, 48, False, "b1"),  # ragged m and n: 4 words a row
    (3, 100, 48, True, "b1"),  # block-padded artifact
    (8, 300, 200, True, "popc"),  # 10 words a row: a stride TMA cannot describe
    (3, 33, 8, False, "popc"),  # 2 words a row
    (4, 2048, 6, False, "popc"),  # weight rows of 6 words
])
def test_hamming_variant_by_shape(monkeypatch, rows, m, n, prepad, variant):
    monkeypatch.setattr(mma_plan, "_sm_count", lambda device: mma_plan.H100_SMS)
    a, w, out = _ham_operands(rows, m, n, prepad)
    assert mma_plan.choose_hamming(a, w, out).variant == variant


@pytest.mark.parametrize("which", ["a", "w", "out"])
def test_hamming_misaligned_pointer_takes_popc(monkeypatch, which):
    monkeypatch.setattr(mma_plan, "_sm_count", lambda device: mma_plan.H100_SMS)
    a, w, out = _ham_operands(8, 2048, 256, False)
    t = {"a": a, "w": w, "out": out}
    t[which] = _aligned(tuple(t[which].shape), torch.int32, offset=1)
    assert mma_plan.choose_hamming(t["a"], t["w"], t["out"]).variant == "popc"
    assert mma_plan.choose_hamming(a, w, out).variant == "b1"


def test_hamming_constants_mirror_the_kernel():
    text = (_build.SRC_DIR / "xnor_matmul.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kBN") == mma_plan.HAM_BN
    assert const("kBKW") == mma_plan.HAM_BKW
    assert const("kMaxSplit") == mma_plan.MAX_SPLIT
    assert const("kMaxStages") == mma_plan.HAM_MAX_STAGES
    assert re.search(r"constexpr int kPitch = kBN \+ (\d+);", text).group(1) == str(
        mma_plan.HAM_PITCH - mma_plan.HAM_BN)
    assert "and.popc" in text and "hamming_matmul_b1" in text
    plan = mma_plan.hamming_plan(8, 64, 5632)
    assert plan.args == (plan.row_tile, plan.split, plan.stages)
    assert "b1" in plan.describe()


@pytest.mark.parametrize("rows,m,n", [(8, 2048, 256), (3, 100, 48), (5, 300, 17), (1, 31, 3)])
def test_and_identity_equals_the_plain_version(rows, m, n):
    """What the b1 variant computes, in plain torch ops: popc(a) per row +
    popc(w) per column - 2 * popc(a & w), summed over the words in any
    split of them, equals ``hamming_matmul_plain`` bit for bit, ragged m
    (zero pad bits on both sides) included."""
    rng = np.random.default_rng(rows * m + n)
    a = ops.pack_bits(torch.from_numpy(rng.random((rows, m)) < 0.5))
    w = ops.pack_weights(torch.from_numpy(np.where(rng.random((m, n)) < 0.5, 1.0, -1.0)))
    kw = a.shape[1]
    want = xnor_matmul.hamming_matmul_plain(a, w)
    pc = xnor_matmul.popcount32
    for split in {1, 2, 3, kw}:
        bounds = np.linspace(0, kw, split + 1).astype(int)
        got = torch.zeros((rows, n), dtype=torch.int64)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            aa, ww = a[:, lo:hi], w[lo:hi]
            both = pc(torch.bitwise_and(aa[:, :, None], ww[None])).sum(dim=1)
            got += pc(aa).sum(dim=1, keepdim=True) + pc(ww).sum(dim=0)[None] - 2 * both
        assert torch.equal(got.to(torch.int32), want), f"split {split}"
