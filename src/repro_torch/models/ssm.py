"""Mamba-2 mixer, SSD (state-space duality) form (counterpart of
``repro/models/ssm.py``).

The reference's layout and arithmetic: unfused input projections (z, x,
B, C, dt) and ``out_proj`` as plain bf16 matmuls (never BitLinears; of
the bf16 copies ``lm.program_weights`` makes once for serving, or cast
per call where a mixer holds none: ``layers.product_weights``), the
depthwise causal conv split to match them, the chunked SSD scan in fp32
(intra-chunk (Q x Q) blocks, chunk end-states, an inter-chunk recurrence
that here is a Python loop over chunks where the reference has a
``lax.scan``), a gated RMSNorm, and a decode cache of the last ``K - 1``
pre-conv values per stream plus the (H, N, P) fp32 state.

Shapes: x (B, S, H, P); dt (B, S, H); A (H,); B/C (B, S, G, N), heads
grouped G | H. Used by ``mamba2-2.7b`` and Jamba's Mamba layers.

Decode keeps each lane's arithmetic independent of the lane count (the
serving invariants on the card): the projections and the state
contraction take their rows as ``kernels/rows.py`` decides, and the
conv taps are unrolled elementwise sums. :func:`mamba_step` writes the
new conv tails and state into the cache it is given, in place, as
``layers.attention_decode_step`` does for K/V.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs
from repro_torch.kernels import rows
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    ACT_DTYPE,
    frozen_parameter,
    gathered,
    hinted,
    product_weights,
    register_resident_,
    rms_norm,
)

SSD_CHUNK = 256


class Mamba(nn.Module):
    """One Mamba-2 mixer's fp32 parameters, named as the reference's
    leaves: the projections (``PROJECTIONS``, each (d_in, d_out); in the
    reference's tree ``{"w": ...}``) and the rest (``VECTORS``). With
    ``resident`` each projection also has its bf16 copy,
    ``<name>_resident`` (``layers.register_resident_``)."""

    PROJECTIONS = ("z_proj", "x_proj", "b_proj", "c_proj", "dt_proj", "out_proj")
    VECTORS = ("conv_x", "conv_b", "conv_c", "conv_bias_x", "conv_bias_b", "conv_bias_c",
               "A_log", "D", "dt_bias", "norm")

    def __init__(self, *, resident: bool = False, **leaves: torch.Tensor):
        super().__init__()
        want = set(self.PROJECTIONS + self.VECTORS)
        if set(leaves) != want:
            raise ValueError(f"Mamba takes {sorted(want)}, got {sorted(leaves)}")
        for name in self.PROJECTIONS + self.VECTORS:
            setattr(self, name, frozen_parameter(leaves[name]))
        register_resident_(self, self.PROJECTIONS, resident)

    def leaves(self) -> dict:
        """The parameters in the reference's slot layout."""
        out = {name: {"w": getattr(self, name)} for name in self.PROJECTIONS}
        out.update({name: getattr(self, name) for name in self.VECTORS})
        return out


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, S, C) depthwise causal conv with kernel (K, C), summed in fp32
    tap by tap."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i : i + s, :].to(torch.float32) * w[i]
    return (out + b).to(x.dtype)


def conv_step(state: torch.Tensor, xt: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Decode: state (B, K-1, C), xt (B, C) -> (new_state, yt)."""
    window = torch.cat([state, xt[:, None, :]], dim=1)  # (B, K, C)
    wf = window.to(torch.float32)
    yt = wf[:, 0] * w[0]
    for i in range(1, w.shape[0]):
        yt = yt + wf[:, i] * w[i]
    return window[:, 1:, :], (yt + b).to(xt.dtype)


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def _groups_to_heads(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """Repeat each group ``rep`` times along ``dim`` (groups -> heads, the
    reference's ``jnp.repeat``) as a broadcast view: its backward is a
    plain sum over the ``rep`` copies, with no index scatter."""
    shape = t.shape
    t = t.unsqueeze(dim + 1).expand(*shape[: dim + 1], rep, *shape[dim + 1 :])
    return t.reshape(*shape[:dim], shape[dim] * rep, *shape[dim + 1 :])


def _chunked(t: torch.Tensor, q: int) -> torch.Tensor:
    """(B, S, ...) -> (B, nc, q, ...) fp32, the sequence zero-padded to
    whole chunks."""
    pad = (-t.shape[1]) % q
    if pad:
        t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
    return t.reshape(t.shape[0], t.shape[1] // q, q, *t.shape[2:]).to(torch.float32)


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int = SSD_CHUNK, cb=None):
    """Chunked SSD scan. Returns (y (B, S, H, P) in x's dtype, final
    state (B, H, N, P) fp32). Differentiable, and deterministic on the
    card: groups reach heads by broadcast views, the chunk recurrence is
    a loop of elementwise ops; its gradient stays finite whatever the
    chunk's summed decay. ``cb`` is the chunks' C.B products (B, nc, G,
    Q, Q), when the caller has them (:func:`ssd_sharded`)."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // q
    f32 = torch.float32

    xc = x.reshape(bsz, nc, q, h, p).to(f32)
    dtc = dt.reshape(bsz, nc, q, h).to(f32)
    bc = b_mat.reshape(bsz, nc, q, g, n).to(f32)
    cc = c_mat.reshape(bsz, nc, q, g, n).to(f32)

    da = dtc * a  # (B, nc, Q, H), a < 0
    cum = torch.cumsum(da, dim=2)

    # intra-chunk (diagonal blocks): attention-like Q x Q products
    ci = cum.transpose(2, 3)  # (B, nc, H, Q)
    # the causal mask goes in before the exp (-inf -> 0), where the
    # reference masks after it: the same values, but a masked entry's
    # exponent grows with the chunk's summed decay, and past ~88 its exp
    # is inf and its gradient 0 * inf = NaN (ROADMAP queue 3)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    l_mat = torch.exp(torch.where(tri, ci[..., :, None] - ci[..., None, :], -torch.inf))
    if cb is None:
        cb = torch.einsum("bnqgs,bnkgs->bngqk", cc, bc)
    cb = _groups_to_heads(cb, rep, 2)  # (B, nc, H, Q, Q)
    m = cb * l_mat * dtc.transpose(2, 3)[:, :, :, None, :]
    y_diag = torch.einsum("bnhqk,bnkhp->bnqhp", m, xc)

    # chunk end-states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, Q, H)
    xw = xc * (dtc * decay_to_end)[..., None]
    bh = _groups_to_heads(bc, rep, 3)  # (B, nc, Q, H, N)
    states = torch.einsum("bnkhs,bnkhp->bnhsp", bh, xw)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)
    hprev = torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
    entering = []
    for i in range(nc):
        entering.append(hprev)
        hprev = states[:, i] + hprev * chunk_decay[:, i, :, None, None]
    hprevs = torch.stack(entering, dim=1)  # (B, nc, H, N, P)

    # off-diagonal contribution
    ch = _groups_to_heads(cc, rep, 3)  # (B, nc, Q, H, N)
    y_off = torch.einsum("bnqhs,bnhsp->bnqhp", ch, hprevs)
    y_off = y_off * torch.exp(cum)[..., None]

    y = (y_diag + y_off).reshape(bsz, nc * q, h, p)[:, :s]
    return y.to(x.dtype), hprev


def ssd_sharded(x, dt, a, b_mat, c_mat):
    """:func:`ssd_chunked` of DTensors, each rank on its own rows and
    heads (the scan is independent per batch row and head): x (B, S, H,
    P) as placed, dt and ``a`` placed to match its heads, B and C
    (B, S, G, N) to match its rows, each rank taking the groups its heads
    read. DTensor cannot keep the heads' sharding through the einsums'
    flattened batch dims and would gather them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, pl = x.device_mesh, x.placements
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl]
    dt = dt.redistribute(mesh, pl)
    a = a.redistribute(mesh, [Shard(0) if isinstance(p, Shard) and p.dim == 2 else Replicate()
                              for p in pl])
    b_mat, c_mat = (t.redistribute(mesh, rows) for t in (b_mat, c_mat))
    # C.B is per group, not per head: its query rows go over the heads'
    # mesh dims, then it is gathered for the local scan
    # (serving; the reference's training step computes it whole on every
    # model rank, as the local scan does)
    cb = None
    if not _training(x):
        q = min(SSD_CHUNK, x.shape[1])
        cc = _chunked(c_mat, q)
        cc = cc.redistribute(mesh, [Shard(2) if isinstance(p, Shard) and p.dim == 2 else r
                                    for p, r in zip(pl, rows)])
        cb = torch.einsum("bnqgs,bnkgs->bngqk", cc, _chunked(b_mat, q)).redistribute(mesh, rows)
    xl = x.to_local()
    h, hl, g = x.shape[2], xl.shape[2], b_mat.shape[2]
    h0 = 0
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == 2:
            h0 = h0 * mesh.shape[i] + mesh.get_local_rank(i)
    h0 *= hl
    rep = h // g
    g0, g1 = h0 // rep, (h0 + hl - 1) // rep + 1
    bl, cl = (t.to_local()[:, :, g0:g1] for t in (b_mat, c_mat))
    if hl % (g1 - g0):  # a group split across ranks: give each head its own
        idx = torch.arange(h0, h0 + hl, device=bl.device) // rep - g0
        bl, cl = bl[:, :, idx], cl[:, :, idx]
    cbl = None if cb is None else cb.to_local()[:, :, g0:g1]
    if cbl is not None and hl % (g1 - g0):
        cbl = cbl[:, :, idx]
    y, final = ssd_chunked(xl, dt.to_local(), a.to_local(), bl, cl, cb=cbl)
    state_pl = [Shard(1) if isinstance(p, Shard) and p.dim == 2 else p for p in pl]
    return (DTensor.from_local(y, mesh, pl, run_check=False),
            DTensor.from_local(final, mesh, state_pl, run_check=False))


def _state_readout(ch: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """(B, H, N) x (B, H, N, P) -> (B, H, P): the sum over N."""
    return torch.matmul(ch[:, :, None, :], state)[:, :, 0]


def ssd_step(state, xt, dtt, a, bt, ct):
    """One decode step. state (B, H, N, P) fp32; xt (B, H, P); dtt (B, H);
    bt/ct (B, G, N). Returns (new_state, yt (B, H, P) in xt's dtype)."""
    rep = xt.shape[1] // bt.shape[1]
    f32 = torch.float32
    decay = torch.exp(dtt.to(f32) * a)  # (B, H)
    bh = _groups_to_heads(bt, rep, 1).to(f32)  # (B, H, N)
    upd = bh[..., :, None] * (xt.to(f32) * dtt[..., None])[..., None, :]
    new_state = state * decay[..., None, None] + upd
    ch = _groups_to_heads(ct, rep, 1).to(f32)
    if type(new_state) not in (torch.Tensor, nn.Parameter):
        # a mesh: C's rows and heads placed as the state's, so that the
        # readout's batched product is each rank's own
        from repro_torch.distributed.hints import placed_like

        ch = placed_like(ch, new_state, 2)
    yt = rows.blocks(_state_readout, (ch, new_state), dim=0)
    return new_state, yt.to(xt.dtype)


# ---------------------------------------------------------------------------
# The mixer
# ---------------------------------------------------------------------------


def _silu_act(t: torch.Tensor) -> torch.Tensor:
    tf = t.to(torch.float32)
    return (tf * torch.sigmoid(tf)).to(ACT_DTYPE)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)``, the reference's softplus formula."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _project(p: Mamba, u: torch.Tensor, name: str) -> torch.Tensor:
    (w,) = product_weights(p, (name,), u.dtype, "ssm.project")
    if name in ("b_proj", "c_proj") and not _training(u):
        # serving: B and C (replicated over the model axis) are left to
        # DTensor, which splits their rows over it, as the reference's
        # compiled prefill and decode do; its training step computes them
        # whole on every model rank, and so does the port's
        return rows.seq_matmul(u, w)
    return rows.seq_matmul(u, gathered(w))


def _training(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _ssm_inputs(p: Mamba, xc, bcv, ccv, dt, cfg: ModelConfig):
    """Post-conv activations -> (x, dt, A, B, C) of the SSD, shaped by the
    leading dims of ``xc``."""
    lead = xc.shape[:-1]
    if type(xc) not in (torch.Tensor, nn.Parameter):  # a mesh: no head split across ranks
        from repro_torch.distributed.hints import hint_heads

        xc = hint_heads(xc, cfg.ssm_heads)
    x = _silu_act(xc).reshape(*lead, cfg.ssm_heads, cfg.ssm_head_dim)
    b_mat = _silu_act(bcv).reshape(*lead, cfg.ssm_groups, cfg.ssm_state)
    c_mat = _silu_act(ccv).reshape(*lead, cfg.ssm_groups, cfg.ssm_state)
    dt = _softplus(dt.to(torch.float32) + p.dt_bias)
    return x, dt, -torch.exp(p.A_log), b_mat, c_mat


def _output(p: Mamba, y, x, z, cfg: ModelConfig) -> torch.Tensor:
    """The D skip, the SiLU(z) gate, the RMSNorm and ``out_proj``."""
    y = y + x.to(torch.float32).to(y.dtype) * p.D[:, None].to(y.dtype)
    y = y.reshape(*y.shape[:-2], cfg.d_inner)
    y = y * _silu_act(z).to(y.dtype)
    y = rms_norm(y, p.norm, cfg.norm_eps)
    return _project(p, y, "out_proj")


def mamba_block(p: Mamba, u: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Full-sequence mixer. u (B, S, d) -> (out (B, S, d), decode cache
    ``{conv_x, conv_b, conv_c}`` (B, K-1, C) bf16 tails of the pre-conv
    streams, left-padded with zeros below K-1 tokens, and ``ssm`` (B, H,
    N, P) fp32), inside the ``ssm.mixer`` profiler range."""
    with obs.range("ssm.mixer"):
        return _mamba_block(p, u, cfg)


def _mamba_block(p: Mamba, u: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    # the reference's hints (its ssm.py mamba_block): z, x and dt over
    # the model axis, B and C replicated
    z = hinted(_project(p, u, "z_proj"), "dp", None, "model")
    x_pre = hinted(_project(p, u, "x_proj"), "dp", None, "model")
    b_pre = _project(p, u, "b_proj")
    c_pre = _project(p, u, "c_proj")
    dt = hinted(_project(p, u, "dt_proj"), "dp", None, "model")
    x, dt, a, b_mat, c_mat = _ssm_inputs(
        p,
        causal_conv1d(x_pre, p.conv_x, p.conv_bias_x),
        causal_conv1d(b_pre, p.conv_b, p.conv_bias_b),
        causal_conv1d(c_pre, p.conv_c, p.conv_bias_c),
        dt, cfg,
    )
    x = hinted(x, "dp", None, "model", None)
    ssd = ssd_chunked if type(x) in (torch.Tensor, nn.Parameter) else ssd_sharded
    y, final = ssd(x, dt, a, b_mat, c_mat)
    out = _output(p, hinted(y, "dp", None, "model", None), x, z, cfg)
    tail = cfg.ssm_conv - 1

    def _tail(t: torch.Tensor) -> torch.Tensor:
        tt = t[:, -tail:, :]
        return F.pad(tt, (0, 0, tail - tt.shape[1], 0)).to(ACT_DTYPE)

    cache = {"conv_x": _tail(x_pre), "conv_b": _tail(b_pre), "conv_c": _tail(c_pre),
             "ssm": final.to(torch.float32)}
    return out, cache


def mamba_step(p: Mamba, ut: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One-token step. ut (B, 1, d); ``cache`` ``{conv_x, conv_b, conv_c,
    ssm}`` with the lanes on dim 0. Writes the new tails and state into
    ``cache`` IN PLACE and returns (out (B, 1, d), cache), inside the
    ``ssm.mixer`` profiler range."""
    with obs.range("ssm.mixer"):
        return _mamba_step(p, ut, cache, cfg)


def _mamba_step(p: Mamba, ut: torch.Tensor, cache: dict, cfg: ModelConfig):
    u = ut[:, 0, :]
    z = _project(p, u, "z_proj")
    cx, xt = conv_step(cache["conv_x"], _project(p, u, "x_proj"), p.conv_x, p.conv_bias_x)
    cb, bt = conv_step(cache["conv_b"], _project(p, u, "b_proj"), p.conv_b, p.conv_bias_b)
    cc, ct = conv_step(cache["conv_c"], _project(p, u, "c_proj"), p.conv_c, p.conv_bias_c)
    x, dt, a, b_mat, c_mat = _ssm_inputs(p, xt, bt, ct, _project(p, u, "dt_proj"), cfg)
    new_ssm, y = ssd_step(cache["ssm"], x, dt, a, b_mat, c_mat)
    out = _output(p, y, x, z, cfg)[:, None, :]
    for key, t in (("conv_x", cx), ("conv_b", cb), ("conv_c", cc), ("ssm", new_ssm)):
        cache[key].copy_(t)
    return out, cache
