"""internvl2-1b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. The ViT frontend
is a STUB per the brief: ``input_specs()`` provides precomputed patch
embeddings (``extra_embeds``) prepended to the token sequence.
"""

from repro_torch.models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    pattern=(LayerKind(mixer="attn"),),
    frontend="vision",
    frontend_len=256,  # 256 ViT patch embeddings per image
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke",
        family="vlm",
        n_layers=2,
        d_model=56,   # keeps head_dim=4 divisible across 14 heads
        n_heads=14,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        pattern=(LayerKind(mixer="attn"),),
        frontend="vision",
        frontend_len=8,
        attn_chunk=32,
        loss_chunk=32,
    )
