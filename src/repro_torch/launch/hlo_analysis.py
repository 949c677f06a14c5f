"""Step analysis of a traced torch step: FLOPs, HBM bytes, collective
bytes, peak memory and the three-term roofline (counterpart of
``repro/launch/hlo_analysis.py``, which reads compiled HLO text).

There is no HLO here. :class:`StepAnalysis` is a ``TorchDispatchMode``
that watches ONE rank's aten ops while a cell's step runs on tensors
that hold no data (``launch/steps.trace_cell``): ``meta`` tensors, as
DTensor shards on a fake process group for a sharded mesh. DTensor ops
are let through to DTensor (the mode answers ``NotImplemented`` for
them), so what the mode counts are the per-rank local ops and the
collectives DTensor's redistributions dispatch -- per-device
quantities, as the reference's post-SPMD shapes are. It records:

* **flops** -- 2 * M * N * K for every matrix product (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``dot``, ``mv``; ``matmul``,
  ``einsum`` and ``linear`` reach those). Convolutions and elementwise
  ops are excluded, as the reference counts only ``dot``.
* **bytes_raw** -- input plus output bytes of every op that is not a
  view, an allocation or a metadata op: what eager torch moves.
* **bytes** -- the same, at the reference's materialization points
  only: products, reductions, copies, ``cat``, indexing, scatter /
  gather, sort, pad, collectives. Elementwise, convert and broadcast
  chains are free (the reference's ``_FUSIBLE_OPS``). Sizes are each
  tensor's own extent, so a copy of a slice of a stacked leaf charges
  the slice, and a view charges nothing.
* **collectives** -- per kind (all-gather, all-reduce, reduce-scatter,
  all-to-all, collective-permute): count, operand bytes and ring wire
  bytes (all-reduce 2x). DTensor's functional collectives
  (``_c10d_functional``) and its shard-to-shard all-to-all
  (``_dtensor::shard_dim_alltoall``) and the process-group ops of
  ``distributed/collectives.py`` (``c10d``) are counted; any other
  collective raises :class:`UnanalysedCollective`, naming it.
* **memory** -- live bytes tracked by this module itself (no
  ``MemTracker``): every storage an op's output brings into being is
  added when first seen and dropped once a ``StorageWeakRef`` to it has
  expired; the arguments are live from the start. ``peak`` is the
  largest live total, kept per stage (before, in and after the
  backward) so that a depth extrapolation extrapolates each stage.

Only ops on the traced tensors' device type are counted: DTensor does
its own index and cost arithmetic on host tensors, and runs each op once
more on fake tensors of the global shape for its output's metadata.

Trip counts (the reference's ``known_trip_count``): a loop of identical
iterations is traced once and counted times its trip count. The
depth is handled by ``steps.trace_cell`` (two and three repeats of the
layer pattern, extrapolated linearly); the 16-row block loop of the
port's row policy (``kernels.rows.blocks``) checks ``kernels.rows.ACTIVE``
and, under an analysis, traces one block inside
:meth:`StepAnalysis.repeat` and builds the rest as uncounted empties
(:meth:`StepAnalysis.uncounted`). The rows are padded to whole blocks
so that a row's bits do not depend on the row count; the padding rows
are not work the step needs, so inside a block the products' FLOPs are
split by :meth:`StepAnalysis.rows` into the real rows' (``flops``) and
the padding's (``row_pad_flops``).

:func:`analyze_trace` gives the reference's record keys. It has no
``xla_cost_flops_tripblind``: that is XLA's own trip-blind
``cost_analysis()``, and torch has no compiler estimate to report.

Roofline constants: NVIDIA H100 SXM5 80GB HBM3 at its 700 W power
limit, from NVIDIA's H100 datasheet::

    compute    = flops_per_dev / 989e12 FLOP/s   (bf16 dense, 700 W)
    memory     = bytes_per_dev / 3.35e12 B/s     (HBM3, 700 W)
    collective = coll_bytes_per_dev / 450e9 B/s  (NVLink 4, per direction per GPU)

A card held below 700 W runs slower under load. The 256- and 512-rank
production meshes cross nodes, whose links are slower than NVLink, so
there the collective term is a lower bound.
"""

from __future__ import annotations

import contextlib
from fractions import Fraction
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import rows

# H100 SXM5 80GB HBM3, 700 W (NVIDIA H100 datasheet)
PEAK_FLOPS = 989e12      # bf16 dense FLOP/s
HBM_BW = 3.35e12         # B/s
NVLINK_BW = 450e9        # B/s per direction per GPU (NVLink 4)
CARD = "H100 SXM5 80GB HBM3, 700 W"

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# (namespace, op name) -> (kind, index of the operand argument)
_COLLECTIVE_OPS = {
    ("_c10d_functional", "all_reduce"): ("all-reduce", 0),
    ("_c10d_functional", "all_reduce_"): ("all-reduce", 0),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", 0),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", 0),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", 0),
    # DTensor's move of a shard from one dim to another on a CUDA mesh
    ("_dtensor", "shard_dim_alltoall"): ("all-to-all", 0),
    ("c10d", "allreduce_"): ("all-reduce", 0),
    ("c10d", "_allgather_base_"): ("all-gather", 1),
    ("c10d", "allgather_into_tensor_coalesced_"): ("all-gather", 1),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", 1),
    ("c10d", "alltoall_base_"): ("all-to-all", 1),
    ("c10d", "send"): ("collective-permute", 0),
    ("c10d", "recv_"): (None, 0),  # the send side counts the exchange
}
_COLLECTIVE_NAMESPACES = {"_c10d_functional", "c10d", "c10d_functional", "_dtensor"}

_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "dot", "vdot", "mv", "addmv", "addbmm"}

# ops that move no bytes of their own: views, allocations, metadata,
# waits and autograd bookkeeping
_FREE = {
    "detach", "alias", "lift_fresh", "lift_fresh_copy", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "resize_", "set_",
    "wait_tensor", "_wrap_tensor_autograd", "record_stream", "_has_compatible_shallow_copy_type",
    "is_same_size", "_unsafe_view", "view", "reshape", "_reshape_alias", "t", "transpose",
    "permute", "expand", "as_strided", "unsqueeze", "squeeze", "slice", "select", "unfold",
    "split", "split_with_sizes", "chunk", "unbind", "narrow", "diagonal", "movedim",
    "view_as", "expand_as", "_conj", "_neg_view", "real", "imag", "unflatten", "flatten",
}

# materialization points: the reference charges these; everything else
# that is not free is an elementwise / convert / broadcast op it fuses
_MATERIALIZE = _PRODUCTS | {
    "convolution", "convolution_backward", "sum", "mean", "amax", "amin", "max", "min",
    "prod", "logsumexp", "var", "var_mean", "std", "norm", "linalg_vector_norm", "cumsum",
    "cumprod", "_log_softmax", "_softmax", "_log_softmax_backward_data",
    "_softmax_backward_data", "any", "all", "argmax", "argmin", "copy_", "copy", "clone",
    "cat", "stack", "index", "index_put", "index_put_",
    "_index_put_impl_", "index_select", "index_add", "index_add_", "index_copy",
    "index_copy_", "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "gather", "take_along_dim", "sort", "topk", "constant_pad_nd", "embedding",
    "embedding_dense_backward", "slice_backward", "select_backward", "index_select_backward",
    "masked_scatter", "nonzero", "repeat", "repeat_interleave", "flip", "roll",
    "_unsafe_index", "_unsafe_index_put", "cumsum_", "one_hot",
}

# mutating ops that do not read the tensor they write
_WRITE_ONLY = {"copy_", "index_put_", "_index_put_impl_", "fill_", "zero_", "normal_",
               "uniform_", "random_", "_unsafe_index_put"}


class UnanalysedCollective(RuntimeError):
    """The trace reached a collective this analysis cannot count."""


class KernelInTrace(RuntimeError):
    """The cell's config reaches a hand-written kernel: a trace cannot
    count it, and counting its plain version instead would describe
    another program."""


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _mm_flops(name: str, args) -> int:
    """2 * M * N * K of one product (the bias add of ``addmm`` excluded)."""
    if name in ("mm",):
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("addmm",):
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "bmm":
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name in ("baddbmm", "addbmm"):
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name in ("dot", "vdot"):
        return 2 * args[0].shape[0]
    if name == "mv":
        return 2 * args[0].shape[0] * args[0].shape[1]
    if name == "addmv":
        return 2 * args[1].shape[0] * args[1].shape[1]
    return 0


class Trace:
    """One traced step's counts (per device): exact integers, and
    fractions where real rows split a padded product."""

    def __init__(self):
        self.flops = Fraction(0)
        self.row_pad_flops = Fraction(0)
        self.bytes = 0
        self.bytes_raw = 0
        self.coll = {k: {"count": 0, "operand_bytes": 0} for k in COLLECTIVES}
        self.argument_bytes = 0
        self.output_bytes = 0
        self.alias_bytes = 0
        # the peak of each stage: before the backward, in it, after it (the
        # optimizer); each is linear in the depth, their maximum is not
        self.stage_peaks = [0, 0, 0]

    @property
    def peak_bytes(self) -> int:
        return max(self.stage_peaks)

    def fields(self) -> dict:
        """Every count, flat (``coll/<kind>/<count|operand_bytes>``,
        ``peak/<stage>``)."""
        out = {k: getattr(self, k) for k in (
            "flops", "row_pad_flops", "bytes", "bytes_raw", "argument_bytes", "output_bytes",
            "alias_bytes", "peak_bytes")}
        for kind, v in self.coll.items():
            for key, n in v.items():
                out[f"coll/{kind}/{key}"] = n
        for i, n in enumerate(self.stage_peaks):
            out[f"peak/{i}"] = n
        return out

    @classmethod
    def from_fields(cls, fields: dict) -> "Trace":
        t = cls()
        for k, v in fields.items():
            if k.startswith("coll/"):
                _, kind, key = k.split("/")
                t.coll[kind][key] = v
            elif k.startswith("peak/"):
                t.stage_peaks[int(k[5:])] = v
            elif k != "peak_bytes":
                setattr(t, k, v)
        return t

    @staticmethod
    def combine(traces: list["Trace"], coefs: list) -> "Trace":
        """``sum(c * t)`` field by field: the depth extrapolation
        (exact: integers and fractions throughout; the peak is the largest
        of the extrapolated stage peaks)."""
        keys = [k for k in traces[0].fields() if k != "peak_bytes"]
        fields = {}
        for k in keys:
            v = sum(Fraction(c) * Fraction(t.fields()[k]) for t, c in zip(traces, coefs))
            fields[k] = v if k in ("flops", "row_pad_flops") else int(v)
        return Trace.from_fields(fields)


class StepAnalysis(TorchDispatchMode):
    """Counts one rank's ops (see the module docstring). Use as a
    context manager around the step; :meth:`add_arguments` first for the
    tensors that are live on entry. ``unroll_blocks=True`` makes the row
    helpers run every block (the exact reference count the multiplied
    blocks are tested against)."""

    def __init__(self, *, unroll_blocks: bool = False, device: str = "meta"):
        super().__init__()
        # the device the traced tensors live on: an op on another one is
        # DTensor's own bookkeeping (index and cost arithmetic on small
        # host tensors, more of it before its caches fill), not the rank's
        self.device = torch.device(device)
        self.trace = Trace()
        self.unroll_blocks = unroll_blocks
        self._mult = 1
        self._row_real = Fraction(1)
        self._row_pad = Fraction(0)
        self._counting = True
        self._live: dict[int, tuple[StorageWeakRef, int]] = {}
        self._live_bytes = 0
        self._since_prune = 0
        self._arg_keys: set = set()
        self._backward_seen = False
        self._node = None          # the (mult, real, pad) of the backward node running
        self.recomputing = False   # inside a checkpoint's rematerialized forward
        self.discarding = False    # inside a checkpoint's first forward
        self._fresh: list | None = None
        self.block_temps = 0

    # -- the loops' trip counts ----------------------------------------------

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Everything counted inside stands for ``n`` identical
        iterations (memory excepted: one iteration's is what is live)."""
        prev = self._mult
        self._mult = prev * n
        try:
            yield
        finally:
            self._mult = prev

    @contextlib.contextmanager
    def rows(self, real, run, padded=None):
        """Products inside run on ``run`` rows of which ``real`` are the
        step's own; the port pads them to ``padded`` (default ``run``).
        Their FLOPs count ``real / run`` as work and ``(padded - real) /
        run`` as padding."""
        padded = run if padded is None else padded
        prev = self._row_real, self._row_pad
        self._row_real = Fraction(real, run) if run else Fraction(0)
        self._row_pad = Fraction(padded - real, run) if run else Fraction(0)
        try:
            yield
        finally:
            self._row_real, self._row_pad = prev

    @contextlib.contextmanager
    def uncounted(self):
        """Ops inside count no FLOPs, bytes or collectives (their
        allocations still count as memory): the empties standing for the
        blocks a multiplied loop does not trace."""
        prev = self._counting
        self._counting = False
        try:
            yield
        finally:
            self._counting = prev

    # -- backward: the nodes a counted block created ---------------------------

    def attach(self, nodes, mult: int, rows: tuple) -> None:
        """Count each of ``nodes``' backward as ``mult`` iterations on
        ``rows`` (hooks: set before the node runs, cleared after)."""
        real, run = rows[0], rows[1]
        padded = rows[2] if len(rows) > 2 else run
        ctx = (mult, Fraction(real, run) if run else Fraction(0),
               Fraction(padded - real, run) if run else Fraction(0))

        def enter(*_):
            self._node = ctx

        def leave(*_):
            self._node = None

        for node in nodes:
            node.register_prehook(enter)
            node.register_hook(leave)

    def count_adds(self, tensors, times: int) -> None:
        """``times`` gradient sums into each of ``tensors`` (3 of its
        sizes each: two read, one written), elementwise."""
        if self._counting:
            self.trace.bytes_raw += 3 * times * sum(_nbytes(t) for t in tensors) * self._mult

    @contextlib.contextmanager
    def fresh(self):
        """Collect the tensors whose storage ops inside bring into being."""
        prev = self._fresh
        self._fresh = out = []
        try:
            yield out
        finally:
            self._fresh = prev

    def shadow(self, tensors, times: int) -> None:
        """Count each of ``tensors``' storage ``1 + times`` over for as
        long as it lives: the storage the untraced iterations of a
        multiplied block would hold at the same time, as a loop that
        keeps them for its backward does."""
        for t in tensors:
            key = t.untyped_storage()._cdata
            ref, n = self._live[key]
            self._live[key] = (ref, n * (1 + times))
            self._live_bytes += n * times
        self._note_alloc()

    def hold(self, nbytes: int) -> None:
        """A peak candidate: what is live now plus ``nbytes`` more."""
        if nbytes:
            self._prune()
            self._note_peak(self._live_bytes + nbytes)

    @contextlib.contextmanager
    def discard(self):
        """A checkpoint's first forward runs inside: what its ops save for
        the backward is dropped (rematerialized later), so no block's
        saved tensors are counted ``n`` times over."""
        prev = self.discarding
        self.discarding = True
        try:
            yield
        finally:
            self.discarding = prev

    @contextlib.contextmanager
    def recompute(self):
        """A checkpoint's rematerialized forward runs inside: it counts as
        forward code (its helpers set their own counting), not as the
        backward node that asked for it."""
        prev = self.recomputing, self.discarding
        self.recomputing, self.discarding = True, False
        try:
            yield
        finally:
            self.recomputing, self.discarding = prev

    def _scale(self):
        if self._node is not None and not self.recomputing:
            return self._node
        return self._mult, self._row_real, self._row_pad

    # -- memory ----------------------------------------------------------------

    def _see(self, t: torch.Tensor) -> int:
        """Register ``t``'s storage if it is new; returns its new bytes."""
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return 0
        key = st._cdata
        old = self._live.get(key)
        if old is not None and not old[0].expired():
            return 0
        n = st.nbytes()
        if old is not None:
            self._live_bytes -= old[1]
        self._live[key] = (StorageWeakRef(st), n)
        self._live_bytes += n
        return n

    def _prune(self) -> None:
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self._live_bytes -= self._live.pop(k)[1]
        self._since_prune = 0

    def _stage(self) -> int:
        if torch._C._current_autograd_node() is not None:
            self._backward_seen = True
            return 1
        return 2 if self._backward_seen else 0

    def _note_peak(self, live: int) -> None:
        peaks = self.trace.stage_peaks
        i = self._stage()
        peaks[i] = max(peaks[i], live)

    def _note_alloc(self) -> None:
        # live bytes only grow between prunes, so an upper bound above
        # the peak is the only moment a prune can find a new peak
        self._since_prune += 1
        if self._live_bytes > self.trace.stage_peaks[self._stage()] or self._since_prune > 4096:
            self._prune()
            self._note_peak(self._live_bytes)

    def add_arguments(self, tensors) -> None:
        """Tensors live on entry (the step's arguments)."""
        for t in tensors:
            self.trace.argument_bytes += self._see(t)
        self._arg_keys = set(self._live)
        self._note_peak(self._live_bytes)

    def set_outputs(self, tensors) -> None:
        """The step's results: their bytes, and the share that is an
        argument's storage updated in place."""
        seen = set()
        for t in tensors:
            st = t.untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            self.trace.output_bytes += st.nbytes()
            if st._cdata in self._arg_keys:
                self.trace.alias_bytes += st.nbytes()

    def finish(self) -> Trace:
        self._prune()
        self._note_peak(self._live_bytes)
        return self.trace

    # -- dispatch ----------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor: its local ops come back here
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation runs the op on fake tensors of
            # the global shape for its output's metadata: not the rank's work
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        outs = list(_tensors(out if isinstance(out, (list, tuple)) else [out]))
        if any(isinstance(t, FakeTensor) for t in outs):
            return out  # a factory op of that same propagation
        first = next(_tensors(list(args) + outs), None)
        if first is not None and first.device.type != self.device.type:
            return out
        name = func._schema.name
        ns, _, op = name.partition("::")
        new = 0
        for t in outs:
            n = self._see(t)
            if n and self._fresh is not None:
                self._fresh.append(t)
            new += n
        if new:
            self._note_alloc()
        if not self._counting:
            return out
        if ns in _COLLECTIVE_NAMESPACES:
            self._collective(ns, op, args)
            return out
        if op in _FREE or func.is_view:
            return out
        mult, real, pad = self._scale()
        if op in _PRODUCTS:
            f = _mm_flops(op, args)
            self.trace.flops += f * mult * real
            self.trace.row_pad_flops += f * mult * pad
        mutated = self._mutated(func, args)
        if op in _WRITE_ONLY:
            ins = sum(_nbytes(t) for i, a in enumerate(args) if i not in mutated
                      for t in _tensors(a))
            nb = 2 * ins if op in ("index_put_", "_index_put_impl_", "_unsafe_index_put") else (
                ins + sum(_nbytes(args[i]) for i in mutated if isinstance(args[i], torch.Tensor)))
        else:
            nb = sum(_nbytes(t) for a in args for t in _tensors(a))
            nb += sum(_nbytes(t) for a in kwargs.values() for t in _tensors(a))
            if not mutated:
                nb += sum(_nbytes(t) for t in outs)
            else:
                nb += sum(_nbytes(args[i]) for i in mutated if isinstance(args[i], torch.Tensor))
        nb *= mult
        self.trace.bytes_raw += nb
        if op in _MATERIALIZE:
            self.trace.bytes += nb
        return out

    @staticmethod
    def _mutated(func, args) -> set:
        return {i for i, a in enumerate(func._schema.arguments[:len(args)])
                if a.alias_info is not None and a.alias_info.is_write}

    def _collective(self, ns: str, op: str, args) -> None:
        spec = _COLLECTIVE_OPS.get((ns, op))
        if spec is None:
            if op in ("wait_tensor", "_wrap_tensor_autograd") or op.startswith("_"):
                return
            raise UnanalysedCollective(f"{ns}::{op} is a collective this analysis cannot count")
        kind, idx = spec
        if kind is None:
            return
        operand = sum(_nbytes(t) for t in _tensors(args[idx]))
        mult = self._scale()[0]
        c = self.trace.coll[kind]
        c["count"] += mult
        c["operand_bytes"] += operand * mult
        # the operand is read and the result written at each end
        nb = 2 * operand * mult
        self.trace.bytes_raw += nb
        self.trace.bytes += nb


@contextlib.contextmanager
def analysing(analysis: StepAnalysis):
    """Enter ``analysis`` and make it the one the row helpers see
    (``kernels.rows.ACTIVE``)."""
    prev = rows.ACTIVE
    rows.ACTIVE = analysis
    try:
        with analysis:
            yield analysis
    finally:
        rows.ACTIVE = prev


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict[str, Any]:
    compute = flops_per_dev / PEAK_FLOPS
    memory = bytes_per_dev / HBM_BW
    collective = coll_bytes_per_dev / NVLINK_BW
    dominant = max(("compute", compute), ("memory", memory), ("collective", collective),
                   key=lambda kv: kv[1])[0]
    return {"compute_s": compute, "memory_s": memory, "collective_s": collective,
            "dominant": dominant}


def analyze_trace(trace: Trace, n_ranks: int) -> dict[str, Any]:
    """The reference's per-cell record from one rank's trace: global
    quantities are per-device ones times ``n_ranks``."""
    flops = float(trace.flops)
    per_kind = {k: {"count": v["count"], "operand_bytes": float(v["operand_bytes"]),
                    "wire_bytes": float(v["operand_bytes"] * (2 if k == "all-reduce" else 1))}
                for k, v in trace.coll.items()}
    operand = sum(v["operand_bytes"] for v in per_kind.values())
    wire = sum(v["wire_bytes"] for v in per_kind.values())
    return {
        "flops": flops * n_ranks,
        "bytes_accessed": float(trace.bytes) * n_ranks,
        "flops_per_dev": flops,
        "row_pad_flops_per_dev": float(trace.row_pad_flops),
        "bytes_per_dev": float(trace.bytes),
        "bytes_raw_per_dev": float(trace.bytes_raw),
        "collectives": {"per_kind": per_kind, "operand_bytes": operand, "wire_bytes": wire},
        "memory": {
            "argument_bytes": int(trace.argument_bytes),
            "output_bytes": int(trace.output_bytes),
            "temp_bytes": int(trace.peak_bytes - trace.argument_bytes),
            "alias_bytes": int(trace.alias_bytes),
            "peak_per_device_bytes": int(trace.peak_bytes),
        },
        "roofline": roofline_terms(flops, float(trace.bytes), operand),
    }
