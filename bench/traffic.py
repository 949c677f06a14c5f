"""The one traffic generator: it reads a mix's parameters
(``bench/traffic/<mix>.json``) and the run's seed, and gives request
sizes and token ids.

Sizes are stratified: each block of ``block`` draws holds the
distribution's quantiles at ``(i + 0.5) / block``, in an order shuffled
by the seed. Every seed then offers the same multiset of work in every
whole block, in another order, so runs with different seeds differ by
the order of the work and not by its amount.

Distributions (``{"dist": ...}``): ``uniform`` (integers ``min`` to
``max``), ``lognormal`` (``median``, ``sigma``, clipped to ``min`` /
``max``, rounded), ``fixed`` (``value``).
"""

from __future__ import annotations

import math
import statistics

import numpy as np

_NORMAL = statistics.NormalDist()


def quantile(dist: dict, u: float) -> float:
    kind = dist["dist"]
    if kind == "uniform":
        lo, hi = int(dist["min"]), int(dist["max"])
        return min(hi, lo + math.floor(u * (hi - lo + 1)))
    if kind == "lognormal":
        x = dist["median"] * math.exp(dist["sigma"] * _NORMAL.inv_cdf(u))
        return min(max(round(x), int(dist["min"])), int(dist["max"]))
    if kind == "fixed":
        return dist["value"]
    raise ValueError(f"unknown distribution {kind!r}")


class Stream:
    """Draws of one distribution: block by block, stratified, shuffled."""

    def __init__(self, dist: dict, seed: int, stream: int, block: int):
        self.dist = dist
        self.block = block
        self.rng = np.random.default_rng([seed, stream])
        self.buf: list = []

    def take(self, n: int) -> list:
        while len(self.buf) < n:
            qs = [quantile(self.dist, (i + 0.5) / self.block) for i in range(self.block)]
            self.buf += [qs[i] for i in self.rng.permutation(self.block)]
        out, self.buf = self.buf[:n], self.buf[n:]
        return out


class Traffic:
    """A mix's request stream for one seed. ``next_request()`` gives
    ``(rid, prompt_len, max_new_tokens)``; ``tokens(rid, n)`` the request's
    prompt ids."""

    def __init__(self, params: dict, seed: int, vocab: int):
        self.params = params
        self.seed = seed
        self.vocab = vocab
        block = int(params.get("block", 64))
        self.prompts = Stream(params["prompt"], seed, 1, block)
        self.outputs = Stream(params["output"], seed, 2, block)
        self.rid = 0

    def next_request(self) -> tuple[int, int, int]:
        rid = self.rid
        self.rid += 1
        return rid, int(self.prompts.take(1)[0]), int(self.outputs.take(1)[0])

    def tokens(self, rid: int, n: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 4, rid])
        return rng.integers(0, self.vocab, size=n, dtype=np.int64).astype(np.int32)
