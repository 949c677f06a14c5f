"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
Every layer is MoE (as released).
"""

from repro_torch.models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    moe_experts=8,
    moe_top_k=2,
    pattern=(LayerKind(mixer="attn", moe=True),),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        moe_experts=4,
        moe_top_k=2,
        pattern=(LayerKind(mixer="attn", moe=True),),
        attn_chunk=32,
        loss_chunk=32,
    )
