"""The variant choice and launch plan of the flash-attention, Hamming and
fused BitLinear kernels, and the exact arithmetic their tensor-core
variants rest on, checked on the CPU (the choice is made in Python, before
the launch, from dtypes, shapes, strides and pointers alone; the fused b1
arithmetic is emulated in torch and held to the plain version and to the
JAX kernel in interpret mode)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_decode as jax_fused
from repro_torch.core import bnn
from repro_torch.kernels import _build, fused_decode, mma_plan, ops
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


def _b1_const(name):
    """A launch-plan constant of the b1 tile loop (``csrc/sm90_b1.cuh``)."""
    text = (_build.SRC_DIR / "sm90_b1.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_hamming_constants_mirror_the_kernel():
    text = (_build.SRC_DIR / "sm90_b1.cuh").read_text()
    assert _b1_const("kBN") == mma_plan.HAM_BN
    assert _b1_const("kBKW") == mma_plan.HAM_BKW
    assert _b1_const("kMaxSplit") == mma_plan.MAX_SPLIT
    assert _b1_const("kMaxStages") == mma_plan.HAM_MAX_STAGES
    assert re.search(r"return wg \* kBN \+ (\d+);", text).group(1) == str(
        mma_plan.HAM_PITCH - mma_plan.HAM_BN)
    assert "and.popc" in text
    assert '#include "sm90_b1.cuh"' in (_build.SRC_DIR / "xnor_matmul.cu").read_text()
    assert "hamming_matmul_b1" in (_build.SRC_DIR / "xnor_matmul.cu").read_text()
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


# ---------------------------------------------------------------------------
# the fused BitLinear
# ---------------------------------------------------------------------------

# tinyllama-1.1b's fused projections (m, n): [q|k|v], q/o, k/v, w1/w3, w2
FUSED_SHAPES = {"qkv": (2048, 2560), "q/o": (2048, 2048), "k/v": (2048, 256),
                "w1/w3": (2048, 5632), "w2": (5632, 2048)}


@pytest.mark.parametrize("x_size", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("rows", HAM_ROWS)
@pytest.mark.parametrize("shape", list(FUSED_SHAPES))
def test_fused_plan_fills_the_card(shape, rows, x_size):
    m, n = FUSED_SHAPES[shape]
    plan = mma_plan.fused_plan(rows, m, n, x_size)
    kt = -(-m // mma_plan.FUSED_FEATURES)
    bn = plan.wg * mma_plan.HAM_BN
    tiles = -(-n // bn) * -(-rows // plan.row_tile)
    assert plan.variant == "b1" and plan.wg in mma_plan.FUSED_WGS
    assert 1 <= plan.split <= mma_plan.MAX_SPLIT
    assert (plan.split - 1) * -(-kt // plan.split) < kt  # every split holds a k stage
    if tiles * min(mma_plan.MAX_SPLIT, kt) >= 128:  # where K allows
        assert plan.ctas >= 128
    assert plan.grid == (plan.split, -(-n // bn), -(-rows // plan.row_tile))
    assert plan.row_tile in mma_plan.FUSED_ROW_TILES and plan.row_tile <= max(8, rows)
    assert 2 <= plan.stages <= mma_plan.HAM_MAX_STAGES
    assert plan.stages <= max(2, -(-kt // plan.split))  # no ring deeper than a split's stages
    assert plan.smem == mma_plan.fused_smem_bytes(plan.row_tile, plan.wg, x_size, plan.stages)
    assert plan.smem <= mma_plan.MAX_SMEM
    # one warpgroup for a decode tick's 8 rows, two (half the packing per
    # output) past it
    assert plan.wg == (1 if rows <= 8 else 2)
    assert plan == mma_plan.fused_plan(rows, m, n, x_size, wg=plan.wg)
    # a grid of more CTAs than SMs: the 2-stage ring (more CTAs per SM);
    # else the deepest that fits
    if plan.ctas > mma_plan.H100_SMS:
        assert plan.stages == 2
    else:
        deeper = plan.stages + 1
        assert (deeper > min(mma_plan.HAM_MAX_STAGES, max(2, -(-kt // plan.split)))
                or mma_plan.fused_smem_bytes(plan.row_tile, plan.wg, x_size, deeper)
                > mma_plan.MAX_SMEM)


def test_fused_decode_shapes_reach_128_ctas():
    """At 8 rows every projection but k/v (two 128-column tiles, 8 k
    stages: 16 CTAs at most) gets >= 128 CTAs, in one warpgroup."""
    for shape, (m, n) in FUSED_SHAPES.items():
        for x_size in (2, 4):
            plan = mma_plan.fused_plan(8, m, n, x_size)
            assert plan.wg == 1 and plan.row_tile == 8
            assert plan.ctas == 16 if shape == "k/v" else plan.ctas >= 128, shape


def test_fused_prefill_takes_the_wide_tile():
    """The lockstep prefill's 1024 rows take two warpgroups, 32-row tiles
    and a 2-stage ring at every projection with n >= 2048 (x packed once
    per 256 columns, four CTAs per SM by shared memory)."""
    for shape, (m, n) in FUSED_SHAPES.items():
        plan = mma_plan.fused_plan(1024, m, n, 2)
        assert plan.wg == 2 and plan.stages == 2, shape
        if n >= 2048:
            assert (plan.row_tile, plan.split) == (32, 1), shape
            assert 4 * (plan.smem + 1024) <= 233472


@pytest.mark.parametrize("shape", ["w1/w3", "w2"])
@pytest.mark.parametrize("wg", mma_plan.FUSED_WGS)
def test_fused_smem_fits_every_forced_plan(shape, wg):
    """Either warpgroup count fits 227 KB at 8, 128 and 1024 rows in both
    dtypes (the probe forces each)."""
    m, n = FUSED_SHAPES[shape]
    for rows in HAM_ROWS:
        for x_size in (2, 4):
            plan = mma_plan.fused_plan(rows, m, n, x_size, wg=wg)
            assert plan.wg == wg and plan.smem <= mma_plan.MAX_SMEM


def _fused_operands(rows, m, n, dtype, *, x_cols=None, prepad=False, ldw=None, offset=0):
    w = ops.pack_weights(torch.ones((m, n)))
    if prepad:
        w = ops.pad_packed_weights(w)
    if ldw is not None:  # weight rows of ldw words, cut to n columns
        w = _aligned((w.shape[0], ldw), torch.int32)[:, :n]
    else:
        w = _aligned(tuple(w.shape), torch.int32)
    x = _aligned((rows, x_cols or m), dtype, offset)
    return x, w, _aligned((rows, n), torch.float32)


@pytest.mark.parametrize("dtype,m,kw_extra,variant", [
    (torch.bfloat16, 2048, {}, "b1"),
    (torch.float32, 2048, {}, "b1"),
    (torch.bfloat16, 2052, {}, "popc"),  # rows of 4104 bytes
    (torch.float32, 2052, {}, "b1"),  # rows of 8208 bytes
    (torch.bfloat16, 100, {}, "popc"),  # the ragged case: rows of 200 bytes
    (torch.bfloat16, 2056, {"x_cols": 2064}, "b1"),  # x wider than m, rows of 4128 bytes
    (torch.bfloat16, 2048, {"prepad": True}, "b1"),  # block-padded artifact
    (torch.bfloat16, 2048, {"ldw": 6}, "popc"),  # weight rows of 6 words
])
def test_fused_variant_by_dtype_and_stride(monkeypatch, dtype, m, kw_extra, variant):
    monkeypatch.setattr(mma_plan, "_sm_count", lambda device: mma_plan.H100_SMS)
    n = 6 if "ldw" in kw_extra else 264
    x, w, out = _fused_operands(8, m, n, dtype, **kw_extra)
    alpha, beta = torch.ones(n), torch.ones(8)
    assert mma_plan.choose_fused(x, w, out, alpha, beta, m=m).variant == variant


@pytest.mark.parametrize("which", ["x", "w", "out"])
def test_fused_misaligned_pointer_takes_popc(monkeypatch, which):
    monkeypatch.setattr(mma_plan, "_sm_count", lambda device: mma_plan.H100_SMS)
    x, w, out = _fused_operands(8, 2048, 256, torch.bfloat16)
    t = {"x": x, "w": w, "out": out}
    t[which] = _aligned(tuple(t[which].shape), t[which].dtype, offset=1)
    alpha, beta = torch.ones(256), torch.ones(8)
    assert mma_plan.choose_fused(t["x"], t["w"], t["out"], alpha, beta).variant == "popc"
    assert mma_plan.choose_fused(x, w, out, alpha, beta).variant == "b1"
    # alpha and beta are read element by element: any base will do
    assert mma_plan.choose_fused(x, w, out, _aligned((256,), torch.float32, 1),
                                 _aligned((8,), torch.float32, 1)).variant == "b1"


def test_fused_constants_mirror_the_kernel():
    header = (_build.SRC_DIR / "sm90_b1.cuh").read_text()
    source = (_build.SRC_DIR / "fused_decode.cu").read_text()
    assert re.search(r"constexpr int kStageFeatures = kBKW \* 32;", header)
    assert mma_plan.FUSED_FEATURES == _b1_const("kBKW") * 32
    assert re.search(r"constexpr int kWBytes = kBN \* kBKW \* 4;", header)
    assert mma_plan.W_BOX_STAGE == _b1_const("kBN") * _b1_const("kBKW") * 4
    # the warpgroup counts and row tiles the C side takes
    assert "(wg == 1 || wg == 2)" in header and mma_plan.FUSED_WGS == (1, 2)
    cases = {int(c) for c in re.findall(r"case (\d+): return launch_n<", header)}
    assert set(mma_plan.FUSED_ROW_TILES) <= cases and set(mma_plan.HAM_ROW_TILES) <= cases
    assert '#include "sm90_b1.cuh"' in source
    for dt in ("bf16", "f32"):
        assert f"fused_bnn_matmul_b1_{dt}(" in source and f"fused_bnn_matmul_{dt}(" in source
    assert mma_plan.FUSED_VARIANTS == ("popc", "b1")
    plan = mma_plan.fused_plan(8, 2048, 5632, 2)
    assert plan.args == (plan.row_tile, plan.wg, plan.split, plan.stages)
    assert "b1" in plan.describe() and "warpgroup" in plan.describe()
    # smem: the header's formula, one warpgroup with packed words equal to
    # the Hamming kernel's
    assert mma_plan.b1_smem_bytes(8, 1, 32, 0, 3) == mma_plan.hamming_smem_bytes(8, 3)
    assert mma_plan.fused_smem_bytes(32, 2, 2, 4) == 1024 + 4 * (2 * 4096 + 32 * (512 + 32)) + 64


def _b1_fused_emulated(x: torch.Tensor, wp: torch.Tensor, alpha, beta, m: int, n: int,
                       split: int) -> torch.Tensor:
    """The fused b1 variant's arithmetic in torch ops, step for step: per
    256-feature k stage the x box as TMA lands it (0 past m), each byte of
    8 features binarized as ``RawRows::bits8`` does (bf16: a 0xFFFF mask
    per feature > -2^-126 for each pair, bits gathered by the kernel's
    masks and shift; fp32: one comparison each), features >= m masked by
    index, the
    bytes little-endian into 8 words a stage; the weight words 0 past kw;
    each of the split's ranks sums popc(a) + popc(w) - 2 popc(a & w) over
    its own stages; then float(m - 2 ham) * (alpha * beta)."""
    rows = x.shape[0]
    kw = -(-m // 32)
    kt = -(-kw // 8)
    box = torch.zeros((rows, kt * 256), dtype=x.dtype)
    box[:, :m] = x[:, :m]
    nbytes = kt * 32
    if x.dtype == torch.bfloat16:
        gt = (box.float() > -(2.0**-126)).to(torch.int64)
        pair = gt[:, 0::2] * 0xFFFF | gt[:, 1::2] * 0xFFFF0000  # __hgt2_mask per word
        m0, m1, m2, m3 = pair.reshape(rows, nbytes, 4).unbind(-1)
        y = (m0 & 0x00010001) | (m1 & 0x00040004) | (m2 & 0x00100010) | (m3 & 0x00400040)
        byte = (y | (y >> 15)) & 0xFF
    else:
        bits = (box > -(2.0**-126)).to(torch.int64).reshape(rows, nbytes, 8)
        byte = (bits << torch.arange(8)).sum(-1)
    f = 8 * torch.arange(nbytes)
    keep = torch.where(f >= m, 0, torch.where(f + 8 > m, (1 << (m - f).clamp(0, 8)) - 1, 0xFF))
    byte = byte & keep
    words = (byte.reshape(rows, kt * 8, 4) << torch.tensor([0, 8, 16, 24])).sum(-1)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    assert torch.equal(words[:, :kw], ops.pack_bits(bnn.nonneg(x[:, :m])))
    w_ext = torch.zeros((kt * 8, n), dtype=torch.int32)
    w_ext[:kw] = wp[:kw, :n]
    pc = xnor_matmul.popcount32
    kt_per = -(-kt // split)
    ham = torch.zeros((rows, n), dtype=torch.int64)
    for rank in range(-(-kt // kt_per)):
        lo, hi = rank * kt_per * 8, min((rank + 1) * kt_per, kt) * 8
        aa, ww = words[:, lo:hi], w_ext[lo:hi]
        both = pc(torch.bitwise_and(aa[:, :, None], ww[None])).sum(dim=1)
        ham += pc(aa).sum(dim=1, keepdim=True) + pc(ww).sum(dim=0)[None] - 2 * both
    return (m - 2 * ham).to(torch.float32) * (alpha.reshape(1, n) * beta.reshape(-1, 1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("rows,m,n", [(3, 100, 48), (8, 300, 130), (5, 257, 7), (2, 530, 40)])
def test_fused_b1_arithmetic_equals_plain_and_jax(rows, m, n, dtype):
    """The fused b1 arithmetic (``_b1_fused_emulated``) on signed zeros,
    NaN and m % 32 != 0, in 1-, 2-, 3- and kt-way splits, equals
    ``fused_bnn_matmul_plain`` and the JAX ``fused_bnn_matmul_kernel``
    (interpret mode) bit for bit, given the same finite beta, and so with
    bf16 subnormals of both signs added: the port binarizes by ``x >
    -2^-126``, which reads a subnormal as zero as XLA's ``x >= 0`` does."""
    rng = np.random.default_rng(rows * 1000 + m + n)
    x = np.array(jnp.asarray(rng.normal(size=(rows, m)), jnp.bfloat16).astype(jnp.float32))
    for j, v in enumerate((0.0, -0.0, np.nan)):
        x[:, j::7] = v
    x[:, -1] = -0.0  # the last, partial word
    wp = ops.pack_weights(torch.from_numpy(rng.choice(np.array([-1.0, 1.0], np.float32),
                                                      size=(m, n))))
    alpha = torch.from_numpy(rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32))
    beta = torch.from_numpy(rng.uniform(0.5, 2.0, size=(rows,)).astype(np.float32))
    kw = wp.shape[0]

    def jax_out(xs):
        return np.asarray(jax_fused.fused_bnn_matmul_kernel(
            jnp.asarray(np.pad(xs, ((0, 0), (0, kw * 32 - m)), constant_values=-1.0)),
            jnp.asarray(wp.numpy()), jnp.asarray(alpha.numpy()[None]),
            jnp.asarray(beta.numpy()[:, None]), m=m, bm=rows, bn=n, bkw=kw, interpret=True))

    tiny = float(2.0**-133)  # bf16's least subnormal
    x_sub = x.copy()
    for j, v in enumerate((tiny, -tiny, 3 * tiny, -3 * tiny)):
        x_sub[:, 3 + j::7] = v
    kt = -(-kw // 8)
    for name, xs in (("edge", x), ("edge + subnormals", x_sub)):
        xt = torch.from_numpy(xs).to(dtype)
        want = fused_decode.fused_bnn_matmul_plain(xt, wp, alpha, beta, m=m, n=n)
        np.testing.assert_array_equal(want.numpy(), jax_out(xs), err_msg=name)
        for split in sorted({1, 2, 3, kt}):
            got = _b1_fused_emulated(xt, wp, alpha, beta, m, n, split)
            assert torch.equal(got, want), f"{name}, split {split}"
