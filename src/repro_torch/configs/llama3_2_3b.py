"""llama3.2-3b [dense] — small llama3 [hf:meta-llama/Llama-3.2 family].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256; llama3 RoPE
base 500k.
"""

from repro_torch.models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    pattern=(LayerKind(mixer="attn"),),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-smoke",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=6,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        rope_theta=500_000.0,
        pattern=(LayerKind(mixer="attn"),),
        attn_chunk=32,
        loss_chunk=32,
    )
