"""PartitionSpec inference: candidate lists + divisibility fallback
(counterpart of ``repro/distributed/partitioner.py``).

Every parameter/input/cache leaf gets an ordered list of candidate
specs (most-sharded first) selected by its tree path; the first
candidate whose every sharded dim divides evenly wins. The rules are the
reference's, so they yield the same layouts across the ten
architectures: TP (heads / FFN hidden / vocab over ``model``), FSDP (the
complementary weight dim over ``data``), EP (MoE experts over ``model``
when E % tp == 0, else FFN-dim TP), SP (decode KV caches
sequence-sharded) and DP (batch over ``pod`` x ``data``).

The rules read a mesh's axis names and sizes only: they take a
:class:`MeshShape` (or a ``DeviceMesh``, turned into one), so the
dry-run builds specs for 512-rank meshes with no process group and no
allocation. Trees are the port's (``repro_torch.tree``: nested dicts of
tensors, ``meta`` ones for shapes), paths the reference's
(``blocks/slot0/attn/q/w``). :func:`to_placements` maps a spec onto a
``DeviceMesh``'s DTensor placements; it stands where the reference's
``named_shardings`` does.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Sequence

from torch.distributed.tensor import Replicate, Shard

from repro_torch import tree as tree_lib

MODEL = "model"


def _entry(axes):
    """One spec entry normalized as ``jax.sharding.PartitionSpec`` does:
    a one-name tuple is the name, an empty tuple ``None``."""
    if isinstance(axes, (tuple, list)):
        axes = tuple(axes)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes
    return axes


class PartitionSpec(tuple):
    """An immutable spec: one entry per leading tensor dim, each ``None``
    (replicated), a mesh axis name, or a tuple of names (sharded over
    their product, outermost first). Trailing dims beyond the entries
    replicate. Equal to the plain tuple of its entries, and a leaf of the
    port's trees (``repro_torch.tree``)."""

    def __new__(cls, *dims):
        return super().__new__(cls, (_entry(d) for d in dims))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, outermost first: all the rules
    read. ``shape`` maps name -> size, as a ``jax.sharding.Mesh``'s
    does."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axis names {self.axis_names} do not match sizes {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def mesh_shape(mesh) -> MeshShape:
    """A :class:`MeshShape` as is, or a ``DeviceMesh``'s names and sizes."""
    if isinstance(mesh, MeshShape):
        return mesh
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh without mesh_dim_names has no axes the rules can name")
    return MeshShape(tuple(names), tuple(int(s) for s in mesh.shape))


def data_axes(mesh) -> tuple[str, ...]:
    """Pure-DP axes: ('pod', 'data') on multi-pod meshes, ('data',) else."""
    return tuple(a for a in mesh_shape(mesh).axis_names if a in ("pod", "data"))


def _axes(entry) -> tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _fits(spec: Sequence, shape: tuple[int, ...], mesh) -> bool:
    sizes = mesh_shape(mesh).shape
    if len(spec) > len(shape):
        return False
    for dim, entry in zip(shape, spec):
        n = 1
        for a in _axes(entry):
            if a not in sizes:
                return False
            n *= sizes[a]
        if dim % n != 0:
            return False
    return True


def first_fitting(candidates: Sequence[P], shape: tuple[int, ...], mesh) -> P:
    for c in candidates:
        if _fits(c, shape, mesh):
            return c
    return P()


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------


def _param_rules(d: str | None, fsdp: bool = False):
    """(path regex, candidates) in the reference's order. ``d`` is the
    data axis for FSDP; leaves under ``blocks`` carry a leading
    repeat/stack dim (``R``), never sharded."""
    R = None
    # ZeRO-3 training: no vocab parallelism (a V-sharded table makes the
    # embedding-grad scatter materialize a full fp32 table per device)
    embed_cands = (
        [P(None, MODEL), P(d, MODEL), P(None, d), P()]
        if fsdp
        else [P(MODEL, d), P(None, MODEL), P(None, d), P()]
    )
    # head stays 2D (d over data, V over model) in both modes: the loss
    # region pins its batch to the data axes ("dp_strict")
    head_cands = [P(d, MODEL), P(MODEL, None), P(d, None), P()]
    return [
        (r"(^|/)embed$", embed_cands),
        (r"(^|/)head$", head_cands),
        (r"attn/[qkv]/w$", [P(R, d, MODEL), P(R, d, None), P(R, None, None)]),
        (r"attn/[qkv]/b$", [P(R, MODEL), P(R, None)]),
        (r"attn/o/w$", [P(R, MODEL, d), P(R, None, d), P(R, None, None)]),
        (r"attn/o/b$", [P(R, None)]),
        (r"ffn/w[13]/w$", [P(R, d, MODEL), P(R, d, None), P(R, None, None)]),
        (r"ffn/w2/w$", [P(R, MODEL, d), P(R, None, d), P(R, None, None)]),
        # MoE: experts over model (EP) else ffn-dim over model (TP)
        (r"moe/router$", [P(R, d, None), P(R, None, None)]),
        (r"moe/w[13]$", [P(R, MODEL, d, None), P(R, None, d, MODEL), P(R, None, d, None),
                         P(R, None, None, None)]),
        (r"moe/w2$", [P(R, MODEL, None, d), P(R, None, MODEL, d), P(R, None, None, d),
                      P(R, None, None, None)]),
        (r"mamba/[zx]_proj/w$", [P(R, d, MODEL), P(R, d, None), P(R, None, None)]),
        (r"mamba/[bc]_proj/w$", [P(R, d, None), P(R, None, None)]),
        (r"mamba/dt_proj/w$", [P(R, d, MODEL), P(R, d, None), P(R, None, None)]),
        (r"mamba/conv_x$", [P(R, None, MODEL), P(R, None, None)]),
        (r"mamba/conv_[bc]$", [P(R, None, None)]),
        (r"mamba/conv_bias_x$", [P(R, MODEL), P(R, None)]),
        (r"mamba/conv_bias_[bc]$", [P(R, None)]),
        (r"mamba/(A_log|D|dt_bias)$", [P(R, MODEL), P(R, None)]),
        (r"mamba/norm$", [P(R, MODEL), P(R, None)]),
        (r"mamba/out_proj/w$", [P(R, MODEL, d), P(R, None, d), P(R, None, None)]),
        # norms and everything else: replicated (beyond the repeat dim)
        (r"norm", [P()]),
    ]


def _strip_lead(spec_dims: tuple, shape: tuple[int, ...]) -> P:
    """Right-align a spec against a shape (leading stack dims -> None)."""
    pad = len(shape) - len(spec_dims)
    if pad < 0:
        return P(*spec_dims[-len(shape):]) if len(shape) else P()
    return P(*([None] * pad), *spec_dims)


def infer_specs(tree: Any, mesh, *, fsdp: bool = False) -> Any:
    """Parameter tree (tensors; ``meta`` for shapes) -> spec tree."""
    sizes = mesh_shape(mesh).shape
    d = "data" if "data" in sizes else None
    rules = [(re.compile(rx), cands) for rx, cands in _param_rules(d, fsdp)]

    def leaf_spec(path, leaf) -> P:
        key = tree_lib.key(path)
        shape = tuple(leaf.shape)
        for rx, cands in rules:
            if rx.search(key):
                return first_fitting([_strip_lead(tuple(c), shape) for c in cands], shape, mesh)
        # default: FSDP the biggest dim over data if it divides
        if shape and d is not None:
            big = max(range(len(shape)), key=lambda i: shape[i])
            return first_fitting([P(*[d if i == big else None for i in range(len(shape))])],
                                 shape, mesh)
        return P()

    return tree_lib.map_with_path(leaf_spec, tree)


def opt_state_specs(param_specs: Any, opt_state: dict) -> dict:
    """Adam m/v (and the fp32 master copy, when present) inherit the
    param specs (a factored ``{vr, vc}`` drops the last / second-to-last
    dim); step is replicated."""

    def v_spec(path, ps: P):
        v = tree_lib.get(opt_state["v"], path)
        if isinstance(v, dict):  # factored {vr, vc}
            dims = tuple(ps)
            return {
                "vr": P(*dims[:-1]) if dims else P(),
                "vc": P(*dims[:-2], *dims[-1:]) if len(dims) >= 2 else P(),
            }
        return ps

    specs = {"step": P(), "m": param_specs, "v": tree_lib.map_with_path(v_spec, param_specs)}
    if "master" in opt_state:
        specs["master"] = param_specs
    return specs


# ---------------------------------------------------------------------------
# Inputs / caches
# ---------------------------------------------------------------------------


def batch_specs(specs_tree: Any, mesh, *, fsdp: bool = False) -> Any:
    """Inputs: batch dim over the DP axes; ``fsdp=True`` tries the model
    axis too (ZeRO-3 training), falling back down a divisibility ladder."""
    dp = data_axes(mesh)
    ladder: list[tuple] = []
    if fsdp:
        ladder.append((*dp, MODEL))
        if len(dp) > 1:  # multi-pod: ("data", "model") before plain DP
            ladder.append((dp[-1], MODEL))
    ladder.append(dp)
    if dp:
        ladder.append((dp[-1],))

    def leaf(_, t) -> P:
        shape = tuple(t.shape)
        if not shape:
            return P()
        return first_fitting([P(c, *([None] * (len(shape) - 1))) for c in ladder], shape, mesh)

    return tree_lib.map_with_path(leaf, specs_tree)


def fsdp_batch_axes(batch_size: int, mesh) -> tuple[str, ...]:
    """The axis tuple the FSDP ladder would give this batch size."""
    dp = data_axes(mesh)
    sizes = mesh_shape(mesh).shape
    for cand in ((*dp, MODEL), (dp[-1], MODEL) if dp else (MODEL,), dp, (dp[-1],) if dp else ()):
        n = 1
        for a in cand:
            n *= sizes.get(a, 10**9)
        if cand and batch_size % n == 0:
            return tuple(cand)
    return ()


def cache_specs(cache_tree: Any, mesh) -> Any:
    """Decode caches. KV caches are (L, B, T, KV, D): batch over data, T
    (sequence) over model; when batch cannot use the data axis
    (long_500k's B = 1), T takes (data, model). SSM states (L, B, H, N,
    P) shard H over model; conv states their channel dim."""
    dp = data_axes(mesh)
    dlast = dp[-1] if dp else None

    def leaf(path, t) -> P:
        key = tree_lib.key(path)
        shape = tuple(t.shape)
        if "ssm" in key and len(shape) == 5:  # (L, B, H, N, P)
            cands = [P(None, dlast, MODEL, None, None), P(None, None, (*dp, MODEL), None, None),
                     P(None, None, MODEL, None, None), P()]
        elif "conv" in key and len(shape) == 4:  # (L, B, K-1, C)
            cands = [P(None, dlast, None, MODEL), P(None, None, None, (*dp, MODEL)),
                     P(None, None, None, MODEL), P()]
        elif len(shape) == 5:  # attention KV (L, B, T, KV, D)
            cands = [P(None, dlast, MODEL, None, None), P(None, None, (*dp, MODEL), None, None),
                     P(None, None, MODEL, None, None), P()]
        elif len(shape) == 4:  # (B, T, KV, D)
            cands = [P(dlast, MODEL, None, None), P(None, MODEL, None, None), P()]
        elif len(shape) >= 1:
            cands = [P(dlast), P()]
        else:
            return P()
        return first_fitting(cands, shape, mesh)

    return tree_lib.map_with_path(leaf, cache_tree)


# ---------------------------------------------------------------------------
# Utilities
# ---------------------------------------------------------------------------


def validate_specs(tree: Any, specs: Any, mesh) -> list[str]:
    """Return a list of violations (empty == all specs divide evenly)."""
    problems: list[str] = []
    for path, leaf in tree_lib.leaves_with_paths(tree):
        spec = tree_lib.get(specs, path)
        if not _fits(spec, tuple(leaf.shape), mesh):
            problems.append(f"{tree_lib.key(path)}: {spec} !~ {tuple(leaf.shape)}")
    return problems


def shard_factor(spec: Sequence, mesh) -> int:
    """How many ways ``spec`` splits a leaf: the product of the sizes of
    the axes it names (each rank holds 1/that of the leaf)."""
    sizes = mesh_shape(mesh).shape
    n = 1
    for entry in spec:
        for a in _axes(entry):
            n *= sizes[a]
    return n


def to_placements(spec: Sequence, mesh) -> tuple:
    """A spec as DTensor placements, one per mesh dim: ``Shard(i)`` on
    each mesh dim that tensor dim ``i`` names, ``Replicate()`` on the
    rest. A dim sharded over several axes (``(*dp, "model")``) gives
    ``Shard(i)`` on each of them, which DTensor splits outermost mesh dim
    first: the reference's block order only when the tuple lists the
    axes in mesh order, so any other order raises, as does an axis named
    twice or one the mesh lacks."""
    names = mesh_shape(mesh).axis_names
    placements: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = []
        for a in _axes(entry):
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in mesh axes {names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {dim}'s axes {_axes(entry)} are not in mesh "
                             f"order {names}")
        for j in idx:
            if not isinstance(placements[j], Replicate):
                raise ValueError(f"spec {spec} shards over mesh axis {names[j]!r} twice")
            placements[j] = Shard(dim)
    return tuple(placements)
