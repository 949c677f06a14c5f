"""KV-prefix-affinity request router (counterpart of
``repro/fleet/router.py``; prefix hits are counted through
:mod:`repro_torch.obs`): token-block hash chains, a two-tier
fleet-global / replica-local prefix index, and the three routing
policies (``prefix``, ``least-loaded``, ``round-robin``).

The rtp-llm ``flexlb`` shape: prompts are cut into fixed token blocks
and each block carries a *chained* hash (block ``i``'s digest covers
blocks ``0..i``), so one dict lookup on the longest chain finds every
replica whose prefix library contains that exact token prefix. Routing
then scores candidates by longest prefix match first, load second.

Two tiers:

* **Fleet-global table** (:attr:`FleetRouter._global`): chain hash ->
  the set of replica ids holding an entry with that prefix. One lookup
  names the candidate replicas; entries leave the table when their
  replica evicts them (LRU) or degrades.
* **Replica-local library** (:class:`PrefixIndex`): a bounded-LRU map
  from chain hashes to :class:`PrefixEntry` — the donor prompt's
  tokens plus its prefill-cache rows (batch-squeezed, on the device).
  Hashes only *select* candidates; the actual graft length is an exact
  element-wise token comparison against the stored prompt, so a hash
  collision can never corrupt a generation (it just wastes a lookup).

The router is pure host-side bookkeeping — it never touches the model.
Correctness (routed == solo, bit-exact) is owned by the
``prefill_continue`` invariant; the router only decides *where* a
request runs and *how much* prefix it may skip (always strictly less
than the prompt, so the first emitted token is computed fresh).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np

from repro_torch import obs

ROUTING_POLICIES = ("prefix", "least-loaded", "round-robin")

DEFAULT_BLOCK = 16


class RoutingConfigError(ValueError):
    """An inconsistent router configuration (unknown policy, bad block
    size or capacity)."""


def chain_hashes(tokens: np.ndarray, block_size: int) -> tuple[bytes, ...]:
    """Chained digests of the prompt's full token blocks.

    Entry ``i`` hashes block ``i``'s tokens together with entry
    ``i-1``'s digest, so it names the exact token prefix of length
    ``(i + 1) * block_size`` — matching chains mean matching prefixes
    (up to hash collision, which the index re-verifies token-wise).
    A trailing partial block contributes no hash.
    """
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out: list[bytes] = []
    digest = b""
    for b in range(len(toks) // block_size):
        block = toks[b * block_size: (b + 1) * block_size]
        digest = hashlib.blake2b(
            digest + block.tobytes(), digest_size=16
        ).digest()
        out.append(digest)
    return tuple(out)


@dataclasses.dataclass
class PrefixEntry:
    """One replica-local prefix-library entry: a donor prompt's tokens,
    its prefill-cache rows, and its hash chain."""

    tokens: np.ndarray            # (prompt_len,) int32, host copy
    rows: Any                     # batch-squeezed cache rows (device)
    hashes: tuple[bytes, ...]     # chain_hashes(tokens, block_size)
    stamp: int = 0                # LRU clock at last touch

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)


class PrefixIndex:
    """Bounded-LRU replica-local prefix library.

    ``insert`` registers a prompt's cache rows under every prefix of
    its hash chain (longest entry wins a contested hash); ``match``
    returns the entry sharing the longest *exact* token prefix with a
    query prompt. Capacity is in entries — each holds one prompt's KV
    rows, so the device-memory bound is ``capacity x max prompt KV``.
    """

    def __init__(self, block_size: int = DEFAULT_BLOCK, capacity: int = 32):
        if block_size < 1:
            raise RoutingConfigError(
                f"block_size must be >= 1 token, got {block_size}"
            )
        if capacity < 1:
            raise RoutingConfigError(
                f"capacity must be >= 1 entry, got {capacity}"
            )
        self.block_size = int(block_size)
        self.capacity = int(capacity)
        self._by_hash: dict[bytes, PrefixEntry] = {}
        self._entries: list[PrefixEntry] = []
        self._clock = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _touch(self, entry: PrefixEntry) -> None:
        self._clock += 1
        entry.stamp = self._clock

    def insert(self, tokens: np.ndarray, rows: Any) -> PrefixEntry | None:
        """Register a prefilled prompt; returns the new entry (or None
        when the prompt is shorter than one block). Evicted LRU entries'
        hashes are released unless a surviving entry also covers them."""
        hashes = chain_hashes(tokens, self.block_size)
        if not hashes:
            return None
        entry = PrefixEntry(
            tokens=np.array(tokens, np.int32, copy=True), rows=rows,
            hashes=hashes,
        )
        self._touch(entry)
        self._entries.append(entry)
        for h in hashes:
            cur = self._by_hash.get(h)
            # longest chain wins: a longer donor prompt serves every
            # shorter match the displaced entry could
            if cur is None or len(cur.hashes) <= len(entry.hashes):
                self._by_hash[h] = entry
        while len(self._entries) > self.capacity:
            self._evict_lru()
        return entry

    def _evict_lru(self) -> PrefixEntry:
        victim = min(self._entries, key=lambda e: e.stamp)
        self._entries.remove(victim)
        for h in victim.hashes:
            if self._by_hash.get(h) is victim:
                del self._by_hash[h]
                for other in self._entries:
                    if h in other.hashes:
                        self._by_hash[h] = other
                        break
        return victim

    def match(self, tokens: np.ndarray) -> tuple[PrefixEntry | None, int]:
        """The entry sharing the longest exact token prefix with
        ``tokens`` and that prefix's length (0 on no block-level hit).

        Hashes select the candidate (longest chain first); the returned
        length is the element-wise common prefix with the stored prompt,
        so it may extend past the last matched block boundary and can
        never exceed what the tokens actually share.
        """
        toks = np.asarray(tokens, np.int32)
        query = chain_hashes(toks, self.block_size)
        for i in range(len(query) - 1, -1, -1):
            entry = self._by_hash.get(query[i])
            if entry is None:
                continue
            n = min(len(entry.tokens), len(toks))
            eq = entry.tokens[:n] == toks[:n]
            common = int(n if eq.all() else np.argmin(eq))
            if common >= self.block_size:
                self._touch(entry)
                return entry, common
        return None, 0

    def hashes(self) -> set[bytes]:
        return set(self._by_hash)


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """Where one request goes and what prefix it may skip."""

    replica: int
    policy: str
    matched_tokens: int = 0       # exact shared-prefix length found
    graft_length: int = 0         # tokens the admission will skip
    entry: PrefixEntry | None = None   # donor entry backing the graft


class FleetRouter:
    """Two-tier prefix index + the routing policies over N replicas.

    ``observe_prefill(rid, tokens, rows)`` feeds a replica's prefix
    library (wired to ``ServingEngine.prefill_observer`` by the pool);
    ``route(tokens, loads)`` picks the replica for a prompt given the
    per-replica load scores of the currently healthy replicas;
    ``forget_replica(rid)`` drops a degraded replica's entries from the
    global table so no new request routes toward its dead library.
    """

    def __init__(
        self,
        replica_ids,
        *,
        policy: str = "prefix",
        block_size: int = DEFAULT_BLOCK,
        capacity: int = 32,
    ):
        if policy not in ROUTING_POLICIES:
            raise RoutingConfigError(
                f"unknown routing policy {policy!r}; "
                f"known: {', '.join(ROUTING_POLICIES)}"
            )
        self.policy = policy
        self.block_size = int(block_size)
        self.indexes: dict[int, PrefixIndex] = {
            rid: PrefixIndex(block_size, capacity) for rid in replica_ids
        }
        if not self.indexes:
            raise RoutingConfigError("a fleet router needs >= 1 replica")
        self._global: dict[bytes, set[int]] = {}
        self._rr = 0
        self.decisions = 0
        self.prefix_hits = 0
        self.hit_tokens = 0

    # -- index maintenance ---------------------------------------------------

    def observe_prefill(self, rid: int, tokens: np.ndarray, rows: Any) -> None:
        index = self.indexes[rid]
        before = index.hashes()
        entry = index.insert(tokens, rows)
        if entry is None:
            return
        for h in entry.hashes:
            self._global.setdefault(h, set()).add(rid)
        for h in before - index.hashes():
            owners = self._global.get(h)
            if owners is not None:
                owners.discard(rid)
                if not owners:
                    del self._global[h]

    def forget_replica(self, rid: int) -> None:
        """Drop a degraded replica from the global table (its local
        library stays allocated but unreachable for routing)."""
        for h, owners in list(self._global.items()):
            owners.discard(rid)
            if not owners:
                del self._global[h]

    # -- routing -------------------------------------------------------------

    def route(
        self, tokens: np.ndarray, loads: dict[int, float]
    ) -> RouteDecision:
        """Pick a replica for a prompt. ``loads`` maps each HEALTHY
        replica id to its load score (lower = freer); degraded replicas
        are simply absent from it."""
        if not loads:
            raise RoutingConfigError("no healthy replica to route to")
        self.decisions += 1
        if self.policy == "round-robin":
            order = sorted(loads)
            rid = order[self._rr % len(order)]
            self._rr += 1
            return RouteDecision(replica=rid, policy=self.policy)
        if self.policy == "least-loaded":
            rid = min(sorted(loads), key=lambda r: loads[r])
            return RouteDecision(replica=rid, policy=self.policy)
        return self._route_prefix(np.asarray(tokens, np.int32), loads)

    def _route_prefix(
        self, tokens: np.ndarray, loads: dict[int, float]
    ) -> RouteDecision:
        query = chain_hashes(tokens, self.block_size)
        candidates: set[int] = set()
        for i in range(len(query) - 1, -1, -1):
            owners = self._global.get(query[i])
            if owners:
                candidates = {r for r in owners if r in loads}
                if candidates:
                    break
        best: tuple[int, PrefixEntry] | None = None
        best_len = 0
        for rid in sorted(candidates):
            entry, matched = self.indexes[rid].match(tokens)
            if entry is None:
                continue
            if matched > best_len or (
                matched == best_len
                and best is not None
                and loads[rid] < loads[best[0]]
            ):
                best = (rid, entry)
                best_len = matched
        if best is None:
            rid = min(sorted(loads), key=lambda r: loads[r])
            return RouteDecision(
                replica=rid, policy=self.policy, matched_tokens=0
            )
        rid, entry = best
        # the last prompt position always prefills fresh (its logits
        # seed the first emitted token), so cap the graft below the
        # prompt; a full-prompt match still skips all but one token
        graft_len = min(best_len, len(tokens) - 1, entry.prompt_len)
        if graft_len < 1:
            rid = min(sorted(loads), key=lambda r: loads[r])
            return RouteDecision(
                replica=rid, policy=self.policy, matched_tokens=best_len
            )
        self.prefix_hits += 1
        self.hit_tokens += graft_len
        obs.count(
            "repro_fleet_prefix_hits_total", 1,
            "routing decisions that found a usable shared prefix",
        )
        return RouteDecision(
            replica=rid, policy=self.policy, matched_tokens=best_len,
            graft_length=graft_len, entry=entry,
        )
