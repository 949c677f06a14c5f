"""Model configuration (own copy of ``repro/models/config.py``'s
``LayerKind`` / ``ModelConfig`` schema and its dry-run cells,
``ShapeConfig`` / ``SHAPES``, so the port imports nothing of ``repro``).

One frozen dataclass covers every family of the reference's pool: the
decoder patterns (attention or Mamba mixers, dense or MoE FFNs), the
encoder-decoder stack (``n_encoder_layers > 0``) and the modality
frontends (``frontend``).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class LayerKind:
    """One slot in the repeating layer pattern."""

    mixer: Literal["attn", "mamba"] = "attn"
    moe: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_shared_ff: int = 0           # a shared SwiGLU expert of this width on every token (0: none)
    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_groups: int = 1
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # layer pattern (period P; n_layers % P == 0)
    pattern: tuple[LayerKind, ...] = (LayerKind(),)
    # enc-dec
    n_encoder_layers: int = 0        # >0 => enc-dec model
    # modality frontend stub (input_specs provides embeddings)
    frontend: Literal["none", "vision", "audio"] = "none"
    frontend_len: int = 256          # patches / frames per sample
    # quantization: "none" or "bnn" (the paper's technique as a feature)
    quant: Literal["none", "bnn"] = "none"
    # execution backend for binarized projections at inference time: any
    # name registered in repro_torch.core.engine ("reference" keeps the
    # plain ±1 matmul; "packed" routes through the XNOR+popcount kernels)
    bnn_engine: str = "reference"
    # layer->tile placement policy of the "tiled" engine (see
    # repro_torch.mapping.POLICIES): what it places a shape with when no
    # compiled MappingPlan covers it
    mapping_policy: str = "tacitmap"
    # misc
    rope: bool = True                # False: no position embedding (NoPE attention)
    rope_theta: float = 10_000.0
    attn_scale: float = 0.0          # attention logits' scale; 0 -> 1 / sqrt(head_dim)
    # Granite's multipliers: the token embeddings times the first, each
    # sublayer's output times the second before its residual add, the
    # logits divided by the third (1 each: no operation)
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    norm_eps: float = 1e-5
    loss_chunk: int = 256            # sequence chunking for the softmax loss
    attn_chunk: int = 512            # KV chunk of the chunked attention
    # "jnp": chunked online-softmax attention in plain ops; "pallas": the
    # flash-attention kernel (kernels/flash_attention.py)
    attn_impl: Literal["jnp", "pallas"] = "jnp"
    # MoE dispatch of the reference (kept for config parity)
    moe_impl: Literal["pjit", "ep_shard_map"] = "pjit"
    remat: bool = True
    # a serving prefill runs each whole sequence's products as one product
    # per sequence instead of 16-row ones (kernels/rows.py): a long prompt
    # then costs one launch a product. Only for a stack that is never
    # continued from a cached prefix (one with a non-attention mixer),
    # whose prompt rows need not equal a continuation's.
    prefill_per_sequence: bool = False

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(f"{self.name}: n_layers {self.n_layers} not divisible by pattern {len(self.pattern)}")
        if self.prefill_per_sequence and all(k.mixer == "attn" for k in self.pattern):
            raise ValueError(
                f"{self.name}: prefill_per_sequence needs a stack that is never continued "
                "from a cached prefix; an attention-only stack is"
            )

    # -- derived ------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables pad the vocab to a multiple of 256, as
        the reference does (vocab-parallel sharding divides any mesh
        axis). Logits beyond ``vocab_size`` are masked to -1e30."""
        return -(-self.vocab_size // 256) * 256

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def has_attn(self) -> bool:
        return any(k.mixer == "attn" for k in self.pattern) or self.is_encdec

    @property
    def has_mamba(self) -> bool:
        return any(k.mixer == "mamba" for k in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k+ context? (SSM/hybrid families.)"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model FLOPs and reports)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_kind = {}
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        ffn_dense = 3 * d * self.d_ff
        ffn_moe = self.moe_experts * 3 * d * self.d_ff + d * self.moe_experts
        ffn_moe += 3 * d * self.moe_shared_ff
        mamba = (
            d * (2 * self.d_inner + 2 * self.ssm_groups * self.ssm_state + self.ssm_heads)
            + self.d_inner * d
            + (self.d_inner + 2 * self.ssm_groups * self.ssm_state) * self.ssm_conv
            + 3 * self.ssm_heads
        )
        total = emb
        for kind in self.pattern:
            mix = attn if kind.mixer == "attn" else mamba
            ff = ffn_moe if kind.moe else ffn_dense
            per_kind[kind] = mix + ff + 2 * d
            total += self.n_repeats * (mix + ff + 2 * d)
        if self.is_encdec:  # encoder layers: self-attn + dense ffn; decoder adds cross-attn
            total += self.n_encoder_layers * (attn + ffn_dense + 2 * d)
            total += self.n_layers * attn  # cross-attention blocks
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k of experts and the
        shared expert)."""
        if self.moe_experts == 0:
            return self.param_count()
        d = self.d_model
        full_ffn = self.moe_experts * 3 * d * self.d_ff
        active_ffn = self.moe_top_k * 3 * d * self.d_ff
        n_moe_layers = sum(1 for k in self.pattern) and sum(
            self.n_repeats for k in self.pattern if k.moe
        )
        return self.param_count() - n_moe_layers * (full_ffn - active_ffn)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell's input geometry."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """The dry-run's skip rules; returns (runs?, reason)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: O(s^2) attention at 524k skipped (DESIGN.md §5)"
    return True, ""
