"""How ``correct`` is decided for a served model: a sample, drawn from
the seed, of what the measured window served, run through the plain
reference, and the share of served tokens whose reference logit lies
below the reference's best at its position (``missed_share``).

Each sampled sequence is ``{"tokens", "extra", "generated",
"routed_calls"}``: the prompt ids, the prepended embeddings (a VLM's
patches; ``None`` otherwise), the served tokens in order, and how the
system routed the rows (its prefill as one call, each decode alone).
The reference reads the prompt and the served tokens once, teacher
forced; the first served token is judged at the last prompt position.

The control puts the reference in the system's place at the precision
below the configuration's (``precision.control``): at each position its
first choice is judged the same way.

A deep binarized stack amplifies every sign that rounding flips, so a
cell whose limits say ``"kind": "layerwise"`` follows the system layer
by layer from its own state instead (:func:`layerwise`).

The reference is the cell's model module's ``Reference`` (see
``bench/spec.py``), handed in by the harness.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
          "float8_e4m3fn": torch.float8_e4m3fn}


def precisions(config: dict) -> tuple[tuple[torch.dtype, torch.dtype],
                                      tuple[torch.dtype, torch.dtype]]:
    """The configuration's stated precision and its control's, each as
    the reference's ``(store, expert_store)``."""
    p = config["precision"]
    act = DTYPES[p["activations"]]
    expert = DTYPES[p.get("experts", p["activations"])]
    low = DTYPES[p["control"]]
    return (act, expert), (low, low)


def sample_sequences(finished: list[dict], seed: int, min_tokens: int) -> list[dict]:
    """The longest finished sequence, then others in an order drawn from
    the seed, until ``min_tokens`` served tokens are in the sample."""
    if not finished:
        return []
    order = sorted(range(len(finished)), key=lambda i: -(len(finished[i]["tokens"])
                                                       + len(finished[i]["generated"])))
    first, rest = order[0], order[1:]
    rng = np.random.default_rng([seed, 5])
    rest = [rest[i] for i in rng.permutation(len(rest))]
    out, n = [], 0
    for i in [first] + rest:
        out.append(finished[i])
        n += len(finished[i]["generated"])
        if n >= min_tokens:
            break
    return out


def _reference_pass(ref, seq: dict, device) -> torch.Tensor:
    tokens = np.asarray(seq["tokens"], np.int64)
    gen = np.asarray(seq["generated"], np.int64)
    ids = torch.as_tensor(np.concatenate([tokens, gen[:-1]]), device=device)
    extra = seq.get("extra")
    n_extra = 0 if extra is None else extra.shape[0]
    start = n_extra + len(tokens) - 1
    rows = torch.arange(start, start + len(gen), device=device)
    return ref.logits(ids, extra, seq["routed_calls"], rows)


def gaps(reference, weights: dict, sz: dict, config: dict, samples: list[dict], device,
         control: bool = False) -> dict:
    """The number of served tokens of ``samples`` judged and the share
    that are not the first choice of ``reference`` (the model module's
    class; with ``control``, of the control's first choices instead)."""
    ref_p, low_p = precisions(config)
    ref = reference(weights, sz, *ref_p)
    low = reference(weights, sz, *low_p) if control else None
    n, missed = 0, 0
    for seq in samples:
        logits = _reference_pass(ref, seq, device)
        if control:
            chosen = _reference_pass(low, seq, device).argmax(dim=-1)
        else:
            chosen = torch.as_tensor(np.asarray(seq["generated"], np.int64), device=device)
        best = logits.max(dim=-1).values
        g = best - logits.gather(1, chosen[:, None])[:, 0]
        n += g.numel()
        missed += int((g > 0).sum())
    return {"tokens": n, "missed_share": missed / max(n, 1)}


def _rel(out: torch.Tensor, ref: torch.Tensor, inp: torch.Tensor) -> float:
    """How far ``out`` lies from ``ref``, as a share of the sublayer's
    own contribution ``ref - inp``."""
    return float((out - ref).norm() / torch.clamp_min((ref - inp).norm(), 1e-30))


def layerwise(reference, weights: dict, sz: dict, config: dict, cap: dict, device,
              control: bool = False) -> dict:
    """Follow the system layer by layer from its own state (``cap``,
    ``WaveDriver.capture``): each attention and FFN sublayer of the
    reference takes the system's input to it, and ``sublayer_err`` is
    the worst distance of the system's output from the reference's, as
    a share of the sublayer's contribution. The head takes the system's
    last residual: ``head_gap`` is the widest gap of a served token.
    With ``control`` the control's sublayers and first choices stand in
    the system's place. A binarized stack amplifies each sign that
    rounding flips, so a whole-sequence comparison at depth would judge
    that chaos, not the system."""
    ref_p, low_p = precisions(config)
    ref = reference(weights, sz, *ref_p)
    low = reference(weights, sz, *low_p) if control else None
    worst, widest, n = 0.0, 0.0, 0
    with torch.no_grad():
        for j in range(len(cap["generated"])):
            gen = np.asarray(cap["generated"][j], np.int64)
            ids = torch.as_tensor(np.concatenate([cap["tokens"][j], gen[:-1]]), device=device)
            x = ref.embed(ids, cap["extra"][j])
            positions = torch.arange(x.shape[0], device=device)
            p = x.shape[0] - len(gen) + 1
            calls = [(0, p)] + [(t, t + 1) for t in range(p, x.shape[0])]
            for i in range(sz["n_layers"]):
                r = cap["R"][i][j].to(torch.float32)
                h = cap["H"][i][j].to(torch.float32)
                want = ref.attention_sublayer(x, i, positions)
                got = low.attention_sublayer(x, i, positions) if control else r
                worst = max(worst, _rel(got, want, x))
                want = ref.ffn_sublayer(r, i, calls)
                got = low.ffn_sublayer(r, i, calls) if control else h
                worst = max(worst, _rel(got, want, r))
                x = h
            last = x[x.shape[0] - len(gen):]
            logits = ref.head(last)
            chosen = (low.head(last).argmax(dim=-1) if control
                      else torch.as_tensor(gen, device=device))
            g = logits.max(dim=-1).values - logits.gather(1, chosen[:, None])[:, 0]
            widest = max(widest, float(g.max()))
            n += len(gen)
    return {"sublayer_err": worst, "head_gap": widest, "tokens": n,
            "replay_mismatch": 0 if control else cap["mismatch"]}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when none is over."""
    shown, ok = {}, True
    for name, lim in limits["numbers"].items():
        v = numbers.get(name)
        shown[name] = {"value": v, "limit": lim["limit"]}
        if v is None or not v <= lim["limit"]:
            ok = False
    return ok, shown
