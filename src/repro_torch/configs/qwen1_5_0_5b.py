"""qwen1.5-0.5b [dense] — QKV bias, tied embeddings [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (MHA: kv=16) d_ff=2816 vocab=151936.
"""

from repro_torch.models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    pattern=(LayerKind(mixer="attn"),),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        qkv_bias=True,
        tie_embeddings=True,
        pattern=(LayerKind(mixer="attn"),),
        attn_chunk=32,
        loss_chunk=32,
    )
