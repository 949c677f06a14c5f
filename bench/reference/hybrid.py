"""The plain reference of the hybrid LMs the benchmark serves
(Granite-4.0-H: Mamba-2 mixers beside NoPE attention, every layer an MoE
with a shared expert): the whole forward over one sequence, written from
the published equations in plain PyTorch, in float32 with TF32 off, with
no kernel, cache, chunking or batching. It imports nothing of the system
under test and takes only the benchmark's own seeded weights and inputs.

From ``bench/reference/decoder.py``, by import: RMSNorm, the paper's
BitLinear (Eq. 1) on q/k/v/o, the capacity-bounded routing replayed per
``routed_calls`` and its routed SwiGLU experts, the storage rounding and
the fp32 guard. Granite's router takes the softmax over the top-10
router logits; the decoder's routing takes the softmax over all experts
and renormalises the top 10, which is the same function.

New here:

* Mamba-2 as the sequential recurrence over time, as the Mamba-2 paper
  states it: a depthwise causal conv1d with bias over (x, B, C), SiLU;
  ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``;
  ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t`` per head (the state
  in fp32, B and C shared by the heads of a group); ``y_t = C_t . h_t +
  D x_t``; the gated RMSNorm of ``y * SiLU(z)``; then ``out_proj``. The
  projections z, x, B, C, dt are the published ``in_proj`` split by its
  output columns; none has a bias.
* Causal GQA attention with no position embedding, logits scaled by
  ``attn_scale`` (Granite's ``attention_multiplier``).
* The shared SwiGLU expert, added to the routed experts' sum for every
  token.
* Granite's multipliers: the token embeddings times
  ``embedding_multiplier``, each sublayer's output times
  ``residual_multiplier`` before its residual add, the tied head's
  logits divided by ``logits_scaling``.

``store`` rounds every value the model stores between operations (and
the Mamba projections' weights); ``expert_store`` the routed and shared
experts' weights. The Mamba state stays fp32, as the configuration
states it. A store with no infinity (fp8 e4m3fn, the control's)
saturates at its largest finite value, as the hardware's conversions to
it do (``satfinite``): some PyTorch versions cast a value past it to NaN,
and one NaN would carry through every later position of the
recurrence, so the control would read a fault of the cast and not the
precision.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .decoder import Decoder, Precision, _fp32, _norm

# formats with no infinity: a store past the largest finite value saturates
_FINITE = (torch.float8_e4m3fn,)


def _silu(t: torch.Tensor) -> torch.Tensor:
    return t * torch.sigmoid(t)


def _saturated(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype in _FINITE:
        top = torch.finfo(dtype).max
        t = t.clamp(-top, top)
    return t.to(dtype).to(torch.float32)


class SaturatingPrecision(Precision):
    """The decoder's storage rounding, saturating where the format has no
    infinity (the module's docstring); the same bits for every other
    format."""

    def rnd(self, t: torch.Tensor) -> torch.Tensor:
        return _saturated(t, self.store)

    def rnd_expert(self, t: torch.Tensor) -> torch.Tensor:
        return _saturated(t, self.expert_store)


class Hybrid(Decoder):
    """The reference over the benchmark's weight dict and size dict (the
    names of ``bench/models/granite.py``'s ``layout`` and ``sizes``):
    ``sz["mixers"][i]`` is layer ``i``'s ``"attn"`` or ``"mamba"``."""

    def __init__(self, weights: dict, sz: dict, store: torch.dtype,
                 expert_store: torch.dtype | None = None):
        super().__init__(weights, sz, store, expert_store)
        self.prec = SaturatingPrecision(store, expert_store)

    def _proj(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self.prec.rnd(x @ self.prec.rnd(self.w[name]))

    def _conv(self, x: torch.Tensor, p: str, part: str) -> torch.Tensor:
        """Depthwise causal conv1d of (T, C) with kernel ``conv_<part>``
        (K, C) and its bias, then SiLU."""
        w, b = self.w[p + "conv_" + part], self.w[p + "conv_bias_" + part]
        k, t = w.shape[0], x.shape[0]
        y = F.conv1d(x.T[None], w.T[:, None, :], b, padding=k - 1, groups=x.shape[1])
        return self.prec.rnd(_silu(self.prec.rnd(y[0, :, :t].T)))

    def _mamba(self, x: torch.Tensor, p: str) -> torch.Tensor:
        sz, rnd = self.sz, self.prec.rnd
        t = x.shape[0]
        h, hp, n, g = sz["ssm_heads"], sz["ssm_head_dim"], sz["ssm_state"], sz["ssm_groups"]
        z = self._proj(x, p + "z_proj")
        xs = self._conv(self._proj(x, p + "x_proj"), p, "x").view(t, h, hp)
        bs = self._conv(self._proj(x, p + "b_proj"), p, "b").view(t, g, n)
        cs = self._conv(self._proj(x, p + "c_proj"), p, "c").view(t, g, n)
        dt = F.softplus(self._proj(x, p + "dt_proj") + self.w[p + "dt_bias"])   # (T, H)
        a = -torch.exp(self.w[p + "A_log"])                                     # (H,)
        group = torch.arange(h, device=x.device) // (h // g)                    # head -> group
        state = torch.zeros((h, n, hp), dtype=torch.float32, device=x.device)
        ys = []
        for i in range(t):
            b_i, c_i = bs[i, group], cs[i, group]                              # (H, N)
            state = (torch.exp(dt[i] * a)[:, None, None] * state
                     + (dt[i, :, None] * b_i)[:, :, None] * xs[i][:, None, :])
            ys.append((c_i[:, :, None] * state).sum(dim=1))                     # (H, P)
        y = rnd(torch.stack(ys))
        y = rnd(y + xs * self.w[p + "D"][:, None])
        y = rnd(y.reshape(t, h * hp) * rnd(_silu(z)))
        y = rnd(_norm(y, self.w[p + "norm"], sz["norm_eps"]))
        return self._proj(y, p + "out_proj")

    def _nope_attention(self, x: torch.Tensor, p: str) -> torch.Tensor:
        sz, rnd = self.sz, self.prec.rnd
        t = x.shape[0]
        h, kv, hd = sz["n_heads"], sz["n_kv_heads"], sz["hd"]
        q = self._bitlinear(x, p + "q").view(t, h, hd).transpose(0, 1)         # (H, T, hd)
        k = self._bitlinear(x, p + "k").view(t, kv, hd).repeat_interleave(h // kv, dim=1)
        v = self._bitlinear(x, p + "v").view(t, kv, hd).repeat_interleave(h // kv, dim=1)
        s = (q @ k.permute(1, 2, 0)) * sz["attn_scale"]                         # (H, T, T)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        s = torch.where(causal, s, float("-inf"))
        out = rnd((torch.softmax(s, dim=-1) @ v.transpose(0, 1)).transpose(0, 1).reshape(t, h * hd))
        return self._bitlinear(out, p + "o")

    def _shared(self, x: torch.Tensor, p: str) -> torch.Tensor:
        prec = self.prec
        h1 = prec.rnd(x @ prec.rnd_expert(self.w[p + "ws1"]))
        h3 = prec.rnd(x @ prec.rnd_expert(self.w[p + "ws3"]))
        return prec.rnd(prec.rnd(prec.rnd(_silu(h1)) * h3) @ prec.rnd_expert(self.w[p + "ws2"]))

    def _residual(self, h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.prec.rnd(h + self.prec.rnd(y * self.sz["residual_multiplier"]))

    # -- the forward, by stage --

    @_fp32
    def embed(self, tokens: torch.Tensor, extra: torch.Tensor | None) -> torch.Tensor:
        if extra is not None:
            raise ValueError("the hybrid LMs take token prompts only")
        return self.prec.rnd(self.w["embed"][tokens] * self.sz["embedding_multiplier"])

    @_fp32
    def mixer_sublayer(self, h: torch.Tensor, i: int) -> torch.Tensor:
        p = f"layers.{i}."
        x = self.prec.rnd(_norm(h, self.w[p + "norm1"], self.sz["norm_eps"]))
        mix = self._nope_attention if self.sz["mixers"][i] == "attn" else self._mamba
        return self._residual(h, mix(x, p))

    @_fp32
    def ffn_sublayer(self, h: torch.Tensor, i: int, routed_calls) -> torch.Tensor:
        p = f"layers.{i}."
        x = self.prec.rnd(_norm(h, self.w[p + "norm2"], self.sz["norm_eps"]))
        y = self.prec.rnd(self._moe(x, p, routed_calls) + self._shared(x, p))
        return self._residual(h, y)

    @_fp32
    def head(self, h: torch.Tensor) -> torch.Tensor:
        hn = self.prec.rnd(_norm(h, self.w["final_norm"], self.sz["norm_eps"]))
        return (hn @ self.w["embed"][: self.sz["vocab_size"]].T) / self.sz["logits_scaling"]

    @_fp32
    def logits(self, tokens: torch.Tensor, extra: torch.Tensor | None,
               routed_calls: list[tuple[int, int]], rows: torch.Tensor) -> torch.Tensor:
        """fp32 logits (len(rows), vocab) of the sequence ``tokens`` at
        positions ``rows``."""
        h = self.embed(tokens, extra)
        for i in range(self.sz["n_layers"]):
            h = self.ffn_sublayer(self.mixer_sublayer(h, i), i, routed_calls)
        return self.head(h[rows])
