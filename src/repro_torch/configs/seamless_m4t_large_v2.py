"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596].

24L (decoder) d_model=1024 16H (MHA kv=16) d_ff=8192 vocab=256206, with
a 24-layer bidirectional encoder over the audio frontend (STUB per the
brief: ``input_specs()`` provides precomputed frame embeddings).
"""

from repro_torch.models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    n_encoder_layers=24,
    pattern=(LayerKind(mixer="attn"),),
    frontend="audio",
    frontend_len=512,  # speech frames per utterance
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        n_encoder_layers=2,
        pattern=(LayerKind(mixer="attn"),),
        frontend="audio",
        frontend_len=16,
        attn_chunk=32,
        loss_chunk=32,
    )
