"""granite-4.0-h-small [hybrid] — Mamba-2 + NoPE GQA 9:1, every layer an
MoE with a shared expert, and Granite's multipliers
[hf:ibm-granite/granite-4.0-h-small, ``model_type`` granitemoehybrid].

40L d_model=4096; attention (32H of 128, GQA kv=8, no position
embedding, logits scaled by 1/128) at layers 5, 15, 25, 35 and Mamba-2
(128 heads of 64, d_state 128, 1 group, conv 4 with bias, chunk 256)
elsewhere, so a period of 10: five Mamba layers, one attention layer,
four Mamba layers. Each layer's FFN is an MoE of 72 experts of 768,
top-10 (softmax over the top-10 logits: the softmax over all 72
renormalised over the top 10, the port's routing), plus a shared SwiGLU
expert of 1536. Embedding x 12, each sublayer's output x 0.22 before its
residual add, logits / 16; vocab 100352, tied embeddings, RMSNorm eps
1e-5.

Departures of the port: the MoE drops assignments past a capacity of
1.25 x the even share (the published model is dropless); under
``quant="bnn"`` attention q/k/v/o are BitLinears while the Mamba
projections, the router and the experts stay real-valued; the Mamba
state runs in fp32 and everything else is stored in bf16.
"""

from repro_torch.models.config import LayerKind, ModelConfig

# attention at slot 5 of 10 (layer_types[5], [15], ...), Mamba elsewhere
_PATTERN = tuple(LayerKind(mixer="attn" if i == 5 else "mamba", moe=True) for i in range(10))

# Granite-4.0-H's attention and multipliers, the same at every size
_GRANITE = dict(
    rope=False,
    attn_scale=0.0078125,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    tie_embeddings=True,
    prefill_per_sequence=True,
)

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    moe_experts=72,
    moe_top_k=10,
    moe_shared_ff=1536,
    ssm_state=128,
    ssm_groups=1,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    pattern=_PATTERN,
    norm_eps=1e-5,
    **_GRANITE,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke",
        family="hybrid",
        n_layers=10,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab_size=256,
        moe_experts=8,
        moe_top_k=3,
        moe_shared_ff=48,
        ssm_state=16,
        ssm_head_dim=16,
        pattern=_PATTERN,
        attn_chunk=32,
        loss_chunk=32,
        **_GRANITE,
    )
