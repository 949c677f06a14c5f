"""The frozen counters against shapes worked by hand, over the decoder
module's per-layer counts."""

from bench import counts
from bench.models.decoder import with_layers

INTERNVL2 = with_layers({"d_model": 896, "n_heads": 14, "n_kv_heads": 2, "hd": 64, "d_ff": 4864,
                         "vocab_size": 151655, "n_layers": 24, "moe_experts": 0, "moe_top_k": 0})
QWEN3 = with_layers({"d_model": 4096, "n_heads": 64, "n_kv_heads": 4, "hd": 128, "d_ff": 1536,
                     "vocab_size": 151936, "n_layers": 1, "moe_experts": 128, "moe_top_k": 8})


def test_fused_qkv_call_internvl2_16_rows():
    # 896 -> 896 + 2 * 128 = 1152 columns; 28 words of 32 signs per column
    assert INTERNVL2["layers"][0]["fused"][0] == (896, 1152)
    x, words, alpha, beta, out = 16 * 896 * 2, 28 * 1152 * 4, 1152 * 4, 16 * 4, 16 * 1152 * 4
    qkv = x + words + alpha + beta + out
    assert qkv == 236096
    # one call of 16 rows: the [q|k|v] launch, o (896 -> 896), w1 and w3
    # (896 -> 4864) and w2 (4864 -> 896, 152 words a column), in each of
    # the 24 layers
    o = 16 * 896 * 2 + 28 * 896 * 4 + 896 * 4 + 16 * 4 + 16 * 896 * 4
    w13 = 16 * 896 * 2 + 28 * 4864 * 4 + 4864 * 4 + 16 * 4 + 16 * 4864 * 4
    w2 = 16 * 4864 * 2 + 152 * 896 * 4 + 896 * 4 + 16 * 4 + 16 * 896 * 4
    assert (o, w13, w2) == (190016, 904256, 761408)
    assert counts.fused_window(INTERNVL2, 1, 16) == (24 * 5, 24 * (qkv + o + 2 * w13 + w2))


def test_fused_window_sums_the_layers_calls():
    launches, nbytes = counts.fused_window(INTERNVL2, 2, 48)
    assert launches == 2 * 24 * 5
    assert nbytes == counts.fused_window(INTERNVL2, 1, 16)[1] + counts.fused_window(
        INTERNVL2, 1, 32)[1]


def test_one_qwen3_moe_token():
    attn = 4096 * (64 + 8) * 128 + 64 * 128 * 4096          # q|k|v and o
    moe = 4096 * 128 + 8 * 3 * 4096 * 1536                  # router, 8 routed SwiGLUs
    assert QWEN3["layers"][0]["macs"] == attn + moe == 222_822_400
    # a token attending over itself, and the head over 151936 ids
    flops = 2 * (222_822_400 + 2 * 64 * 128 * 1 + 4096 * 151936)
    assert counts.decode_flops(QWEN3, 1) == flops == 1_690_337_280


def test_prefill_counts_the_causal_context_and_one_head_row():
    s = 10
    want = 2 * (s * QWEN3["layers"][0]["macs"] + 2 * 64 * 128 * (s * (s + 1) // 2) + 4096 * 151936)
    assert counts.prefill_flops(QWEN3, s) == want


def test_only_layers_that_attend_count_the_context():
    """A layer with no attention (a state-space mixer, say) adds its own
    products and no term over the context; layers may differ."""
    mixer = {"macs": 1000, "attn_heads": 0, "attn_hd": 0, "fused": [(64, 32)]}
    attn = {"macs": 3000, "attn_heads": 4, "attn_hd": 16, "fused": [(64, 96), (64, 64)]}
    sz = {"d_model": 64, "vocab_size": 100, "layers": [mixer, attn, mixer]}
    assert counts.decode_flops(sz, 1) == 2 * (5000 + 2 * 4 * 16 * 1 + 64 * 100)
    assert counts.decode_flops(sz, 9) - counts.decode_flops(sz, 1) == 2 * 2 * 4 * 16 * 8
    launches, nbytes = counts.fused_window(sz, 1, 1)
    assert launches == 4
    one = {(m, n): -(-m // 32) * n * 4 + n * 4 + m * 2 + 4 + n * 4
           for m, n in ((64, 32), (64, 96), (64, 64))}
    assert nbytes == 2 * one[64, 32] + one[64, 96] + one[64, 64]
