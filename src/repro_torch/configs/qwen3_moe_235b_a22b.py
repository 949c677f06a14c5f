"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B
family scaling].

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per-expert) vocab=151936,
MoE 128e top-8, every layer MoE. Fine-grained experts: d_ff is small
(1536) but 128 of them exist per layer.
"""

from repro_torch.models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    moe_experts=128,
    moe_top_k=8,
    pattern=(LayerKind(mixer="attn", moe=True),),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=32,
        vocab_size=256,
        moe_experts=8,
        moe_top_k=4,
        pattern=(LayerKind(mixer="attn", moe=True),),
        attn_chunk=32,
        loss_chunk=32,
    )
