"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""

from repro_torch.models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    pattern=(LayerKind(mixer="attn"),),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        pattern=(LayerKind(mixer="attn"),),
        attn_chunk=32,
        loss_chunk=32,
    )
