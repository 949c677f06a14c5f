"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave with
MoE [arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Jamba period: 8 layers with 1 attention layer (index 4, as published)
and MoE on every other layer (odd indices) -> 9 repeats of the pattern.
"""

from repro_torch.models.config import LayerKind, ModelConfig

# attn at slot 4 of 8 (1:7), MoE every second layer
_PATTERN = tuple(
    LayerKind(mixer="attn" if i == 4 else "mamba", moe=(i % 2 == 1)) for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe_experts=16,
    moe_top_k=2,
    ssm_state=128,
    ssm_groups=1,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    pattern=_PATTERN,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        moe_experts=4,
        moe_top_k=2,
        ssm_state=16,
        ssm_head_dim=16,
        pattern=tuple(
            LayerKind(mixer="attn" if i == 1 else "mamba", moe=(i % 2 == 1))
            for i in range(4)
        ),
        attn_chunk=32,
        loss_chunk=32,
    )
