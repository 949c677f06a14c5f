"""mamba2-2.7b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

64L d_model=2560 (attn-free) d_ff=0 (mixer-only blocks) vocab=50280,
ssm_state=128. d_inner = 2*d = 5120, head_dim 64 -> 80 SSD heads.
"""

from repro_torch.models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,          # unused (attn-free); SSD heads derive from d_inner
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_groups=1,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    tie_embeddings=True,
    pattern=(LayerKind(mixer="mamba"),),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=256,
        ssm_state=16,
        ssm_head_dim=16,
        tie_embeddings=True,
        pattern=(LayerKind(mixer="mamba"),),
        attn_chunk=32,
        loss_chunk=32,
    )
