"""The plain reference of the decoder LMs the benchmark serves: the
whole forward over one sequence, written from the model's equations in
plain PyTorch, in float32 with TF32 off, with no kernel, cache or
batching. It imports nothing of the system under test and takes only
the benchmark's own seeded weights and inputs.

* Embedding lookup; pre-norm residual layers; RMSNorm ``x *
  rsqrt(mean(x^2) + eps) * scale``.
* BitLinear, the paper's Eq. 1: ``(sign(x) @ sign(W)) * alpha * beta``
  with ``sign(0) = +1``, ``alpha = mean|W|`` per tensor and ``beta =
  mean|x|`` per row, plus the bias where the model has one.
* RoPE (rotate-half, ``theta ** (-i / (hd / 2))``) on q and k; causal GQA
  attention, softmax in fp32.
* MoE: fp32 router, softmax over all experts, the ``top_k`` largest
  (ties to the lower index), renormalised; each expert a SwiGLU; the
  capacity rule of the system's dispatch, ``ceil(rows * top_k / E *
  factor)`` assignments per expert per routed call in (row, rank)
  order, the rest dropped. ``routed_calls`` says which rows were routed
  together: the prompt as one call, each decoded token alone.
* Dense SwiGLU ``w2(silu(w1 x) * w3 x)``; the head (or the tied
  embedding) in fp32 over the real vocabulary.

``store`` is the dtype the configuration states for activations and the
KV cache (and ``expert_store`` for the expert weights): every value the
model stores between operations is rounded to it, while the arithmetic
stays fp32. The control runs the same code with a lower ``store``. Each
public stage runs with TF32 off and no autograd, whoever calls it.
"""

from __future__ import annotations

import functools
import math

import torch


class Precision:
    def __init__(self, store: torch.dtype, expert_store: torch.dtype | None = None):
        self.store = store
        self.expert_store = expert_store or store

    def rnd(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.store).to(torch.float32)

    def rnd_expert(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.expert_store).to(torch.float32)


def _signs(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t >= 0, 1.0, -1.0).to(torch.float32)


def _norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, hd)."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions.to(torch.float32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _fp32(fn):
    """``fn`` with fp32 products in fp32 (TF32 off) and no autograd."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with no_tf32(), torch.no_grad():
            return fn(*args, **kwargs)

    return run


class Decoder:
    """The reference over the benchmark's weight dict and size dict (the
    names of ``bench/models/decoder.py``'s ``layout`` and ``sizes``),
    storing values as ``store`` (expert weights as ``expert_store``)."""

    def __init__(self, weights: dict, sz: dict, store: torch.dtype,
                 expert_store: torch.dtype | None = None):
        self.w = weights
        self.sz = sz
        self.prec = Precision(store, expert_store)
        self._signs: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def _bitlinear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if name not in self._signs:
            w = self.w[name]
            self._signs[name] = (_signs(w), w.abs().mean())
        sw, alpha = self._signs[name]
        beta = x.abs().mean(dim=-1, keepdim=True)
        out = self.prec.rnd((_signs(x) @ sw) * (alpha * beta))
        bias = self.w.get(name + "_bias")
        return out if bias is None else self.prec.rnd(out + bias)

    def _attention(self, x: torch.Tensor, p: str, positions: torch.Tensor) -> torch.Tensor:
        sz, rnd = self.sz, self.prec.rnd
        t = x.shape[0]
        h, kv, hd = sz["n_heads"], sz["n_kv_heads"], sz["hd"]
        q = rnd(_rope(self._bitlinear(x, p + "q").view(t, h, hd), positions, sz["rope_theta"]))
        k = rnd(_rope(self._bitlinear(x, p + "k").view(t, kv, hd), positions, sz["rope_theta"]))
        v = self._bitlinear(x, p + "v").view(t, kv, hd)
        g = h // kv
        k = k.repeat_interleave(g, dim=1).transpose(0, 1)      # (H, T, hd)
        v = v.repeat_interleave(g, dim=1).transpose(0, 1)
        s = (q.transpose(0, 1) @ k.transpose(1, 2)) / math.sqrt(hd)   # (H, T, T)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        s = torch.where(causal, s, float("-inf"))
        out = rnd((torch.softmax(s, dim=-1) @ v).transpose(0, 1).reshape(t, h * hd))
        return self._bitlinear(out, p + "o")

    def _dense_ffn(self, x: torch.Tensor, p: str) -> torch.Tensor:
        rnd = self.prec.rnd
        h1 = self._bitlinear(x, p + "w1")
        h3 = self._bitlinear(x, p + "w3")
        return self._bitlinear(rnd(rnd(h1 * torch.sigmoid(h1)) * h3), p + "w2")

    def _moe(self, x: torch.Tensor, p: str, routed_calls: list[tuple[int, int]]) -> torch.Tensor:
        sz, prec = self.sz, self.prec
        e, k = sz["moe_experts"], sz["moe_top_k"]
        probs = torch.softmax(x @ self.w[p + "router"], dim=-1)
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[:, :k], idx[:, :k]
        gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
        keep = torch.zeros_like(gates, dtype=torch.bool)
        for a, b in routed_calls:
            cap = max(1, math.ceil((b - a) * k / e * sz["moe_capacity_factor"]))
            flat = idx[a:b].reshape(-1)
            onehot = torch.nn.functional.one_hot(flat, e)
            slot = (onehot.cumsum(dim=0) - 1).gather(1, flat[:, None])[:, 0]
            keep[a:b] = (slot < cap).view(b - a, k)
        y = torch.zeros_like(x)
        for ex in torch.unique(idx[keep]).tolist():
            rows, rank = torch.nonzero((idx == ex) & keep, as_tuple=True)
            xe = x[rows]
            h1 = prec.rnd(xe @ prec.rnd_expert(self.w[p + "w1"][ex]))
            h3 = prec.rnd(xe @ prec.rnd_expert(self.w[p + "w3"][ex]))
            a = prec.rnd(prec.rnd(h1 * torch.sigmoid(h1)) * h3)
            out = prec.rnd(a @ prec.rnd_expert(self.w[p + "w2"][ex]))
            y.index_add_(0, rows, out * gates[rows, rank][:, None])
        return prec.rnd(y)

    # -- the forward, and its stages for a check that follows the system --

    @_fp32
    def embed(self, tokens: torch.Tensor, extra: torch.Tensor | None) -> torch.Tensor:
        h = self.prec.rnd(self.w["embed"][tokens])
        if extra is not None:
            h = torch.cat([self.prec.rnd(extra.to(torch.float32)), h], dim=0)
        return h

    @_fp32
    def attention_sublayer(self, h: torch.Tensor, i: int, positions: torch.Tensor) -> torch.Tensor:
        p = f"layers.{i}."
        x = self.prec.rnd(_norm(h, self.w[p + "norm1"], self.sz["norm_eps"]))
        return self.prec.rnd(h + self._attention(x, p, positions))

    @_fp32
    def ffn_sublayer(self, h: torch.Tensor, i: int, routed_calls) -> torch.Tensor:
        p = f"layers.{i}."
        x = self.prec.rnd(_norm(h, self.w[p + "norm2"], self.sz["norm_eps"]))
        y = self._moe(x, p, routed_calls) if self.sz["moe_experts"] else self._dense_ffn(x, p)
        return self.prec.rnd(h + y)

    @_fp32
    def head(self, h: torch.Tensor) -> torch.Tensor:
        hn = self.prec.rnd(_norm(h, self.w["final_norm"], self.sz["norm_eps"]))
        v = self.sz["vocab_size"]
        head = self.w["embed"][:v].T if self.sz["tie_embeddings"] else self.w["head"][:, :v]
        return hn @ head

    @_fp32
    def logits(self, tokens: torch.Tensor, extra: torch.Tensor | None,
               routed_calls: list[tuple[int, int]], rows: torch.Tensor) -> torch.Tensor:
        """fp32 logits (len(rows), vocab) of the sequence ``[extra,
        embed(tokens)]`` at positions ``rows``."""
        h = self.embed(tokens, extra)
        positions = torch.arange(h.shape[0], device=h.device)
        for i in range(self.sz["n_layers"]):
            h = self.ffn_sublayer(self.attention_sublayer(h, i, positions), i, routed_calls)
        return self.head(h[rows])


class no_tf32:
    """fp32 products in fp32: TF32 off for the block, restored after."""

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev
        return False
