"""The row policy: every per-row product and reduction runs in calls
whose shape does not depend on how many rows share them.

A GEMM or a reduction picks its algorithm by shape (a CPU GEMM takes
another path for a handful of rows, a CUDA one by M and batch count;
CUDA's reduction lays out fewer than :data:`MEAN_ROWS` rows another
way), so a row's bits could depend on the row count. Serving needs them
not to: 8 slots == alone, a grafted continuation == the full prefill, a
replayed decode graph == the eager step. So:

* products run in blocks of :data:`ROWS` rows, one call per block
  (:func:`blocks`, :func:`matmul`), aligned to a row's absolute position
  where a continuation needs it;
* row means and sums pad their calls to :data:`MEAN_ROWS` rows
  (:func:`row_mean`, :func:`row_sum`);
* a prefill inside :func:`sequence_products` (a config with
  ``prefill_per_sequence``: a stack never continued from a cached
  prefix, whose prompt rows need not equal a continuation's) takes one
  product per sequence at the sites that call :func:`by_sequence`.

Traced whole, a 65,536-row product is 4,096 calls. Under an active
``launch.hlo_analysis.StepAnalysis`` (``ACTIVE``, set by
``hlo_analysis.analysing``) the block loop is counted the way the
reference's ``known_trip_count`` counts one:

* plain tensors: one block is traced inside ``repeat(n)`` and the other
  ``n - 1`` are empties built under ``uncounted()`` (their memory
  counts, nothing else), then joined as the loop joins them. The counts
  equal the unrolled loop's exactly (``unroll_blocks=True`` runs it);
* DTensors (a sharded mesh): the rows run as one call on the DTensor,
  so no block slices a sharded dim (which would gather it): each rank's
  rows are its shard's, and rows are independent.

Either way the products' FLOPs are split into the real rows' and the
padding's (``StepAnalysis.rows``). Outside an analysis the loop pays one
module-level ``None`` check.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn

ROWS = 16  # rows per product call
# CUDA's reduction kernel lays out fewer rows than this differently (a
# wider block, another summation tree); smaller calls are padded to it
MEAN_ROWS = 16
# the types that are not a mesh's DTensors
PLAIN = (torch.Tensor, nn.Parameter)

# the active StepAnalysis, or None
ACTIVE = None
# whether this thread runs inside sequence_products
_MODE = threading.local()


def is_sharded(*ts) -> bool:
    """Whether any of ``ts`` is a DTensor."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in ts)


def _local_rows(t: torch.Tensor, dim: int) -> int:
    from torch.distributed.tensor import DTensor

    return (t.to_local() if isinstance(t, DTensor) else t).shape[dim]


def _pad_to(n: int) -> int:
    return -(-n // ROWS) * ROWS


def _block_nodes(out: torch.Tensor, inputs) -> list:
    """The autograd nodes ``out``'s block created: from ``out.grad_fn``
    back to (not including) the inputs' own nodes and any leaf's
    ``AccumulateGrad``."""
    stop = [x.grad_fn for x in inputs if x.grad_fn is not None]
    nodes, todo = [], [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or any(node is s for s in stop) or any(node is n for n in nodes):
            continue
        if type(node).__name__ == "AccumulateGrad":
            continue
        nodes.append(node)
        todo.extend(n for n, _ in node.next_functions)
    return nodes


def _run(an, mult: int, rows: tuple, fn, *inputs) -> torch.Tensor:
    """``fn(*inputs)`` counted as ``mult`` iterations on ``rows``
    (``StepAnalysis.rows``' arguments), forward and backward: autograd
    runs a node's backward outside any context, so each node the block
    creates carries its counting (``StepAnalysis.attach``). A loop's
    ``mult`` iterations would each add a gradient into every input's:
    the ``mult - 1`` sums are counted as the adds they are."""
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in inputs)
    with an.repeat(mult), an.rows(*rows), an.fresh() as fresh:
        out = fn(*inputs)
    temps = [t for t in fresh if t.untyped_storage()._cdata != out.untyped_storage()._cdata]
    if grad and mult > 1 and not an.discarding:  # what it saves for its backward, n times
        an.shadow(temps, mult - 1)
    # a loop's last block holds its temporaries next to the others' outputs
    an.block_temps = (0 if grad and not an.discarding
                      else sum(t.untyped_storage().nbytes() for t in temps))
    if out.grad_fn is not None and not an.recomputing:
        an.attach(_block_nodes(out, inputs), mult, rows)
        if mult > 1:
            an.count_adds([x for x in inputs if x.requires_grad], mult - 1)
    return out


def _blocks(an, n: int, real: list[int], block, inputs, dim: int) -> torch.Tensor:
    """``cat([block(i, *inputs) for i in range(n)], dim)``, block ``i``
    holding ``real[i]`` real rows of ``ROWS``: every block traced when
    the analysis unrolls, else block 0 times ``n`` and empties."""
    if an.unroll_blocks:
        outs = [_run(an, 1, (real[i], ROWS), lambda *xs, i=i: block(i, *xs), *inputs)
                for i in range(n)]
    else:
        first = _run(an, n, (sum(real), ROWS * n), lambda *xs: block(0, *xs), *inputs)
        with an.uncounted():
            outs = [first] + [torch.empty_like(first) for _ in range(n - 1)]
        an.hold(an.block_temps)
    return torch.cat(outs, dim=dim)


def _pad(t: torch.Tensor, dim: int, front: int, back: int) -> torch.Tensor:
    """``t`` zero-padded by ``front`` rows before and ``back`` after, along ``dim``."""
    return F.pad(t, (0, 0) * (t.ndim - 1 - dim % t.ndim) + (front, back))


def blocks(fn, blocked: tuple, shared: tuple = (), *, dim: int, front: int = 0) -> torch.Tensor:
    """``fn(*blocks, *shared)`` over ``ROWS``-row blocks of the
    ``blocked`` tensors along ``dim``, ``shared`` passed whole to every
    call: the rows are zero-padded by ``front`` before row 0 and to a
    whole block after the last one, one call per block, and the outputs
    are joined on ``dim`` and cut back to the rows."""
    an = ACTIVE
    if an is not None and is_sharded(*blocked, *shared):
        ml = _local_rows(blocked[0], dim)
        return _run(an, 1, (ml, ml, _pad_to(front + ml)), fn, *blocked, *shared)
    m = blocked[0].shape[dim]
    back = (-(front + m)) % ROWS
    if front or back:
        blocked = tuple(_pad(t, dim, front, back) for t in blocked)
    n, k = (front + m + back) // ROWS, len(blocked)

    def block(i, *xs):
        return fn(*(x.narrow(dim, i * ROWS, ROWS) for x in xs[:k]), *xs[k:])

    if an is None:
        out = torch.cat([block(i, *blocked, *shared) for i in range(n)], dim=dim)
    else:
        real = [min(front + m, (i + 1) * ROWS) - max(front, i * ROWS) for i in range(n)]
        out = _blocks(an, n, real, block, (*blocked, *shared), dim)
    return out.narrow(dim, front, m) if front or back else out


def checkpoint_kw() -> dict:
    """Extra arguments for ``torch.utils.checkpoint.checkpoint`` under
    the active analysis: a forward context that tells it the tensors
    saved for backward are dropped, and a recompute context that tells it
    the ops it sees are the rematerialized forward's (``{}`` otherwise)."""
    if ACTIVE is None:
        return {}
    an = ACTIVE
    return {"context_fn": lambda: (an.discard(), an.recompute())}


def matmul(a: torch.Tensor, b: torch.Tensor, first_row: int = 0) -> torch.Tensor:
    """``a @ b`` with every product call of one shape, whatever the row
    count: a (..., M, K) x (..., K, N) runs in blocks of :data:`ROWS`
    rows of M, aligned to absolute row ``first_row + i``, one batched
    call per block; a weight ``b`` (K, N) takes ``a``'s leading dims
    flattened into the rows, so each call is (ROWS, K) x (K, N) (a
    batched (B, ROWS, K) call may take another GEMM path). A row's bits
    then depend neither on the batch nor on how many rows share the
    product: a continuation's rows equal the full pass's, a lane's its
    solo run's."""
    if b.ndim == 2 and a.ndim > 2:
        out = matmul(a.reshape(-1, a.shape[-1]), b, first_row)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return blocks(lambda a, b: torch.matmul(a.contiguous(), b), (a,), (b,),
                  dim=-2, front=first_row % ROWS)


def _row_reduce(x: torch.Tensor, reduce) -> torch.Tensor:
    if ACTIVE is not None and is_sharded(x):  # a step analysis: no flattening
        return reduce(x).unsqueeze(-1)         # of a sharded dim
    x2 = x.reshape(-1, x.shape[-1])
    rows = x2.shape[0]
    if rows < MEAN_ROWS:
        x2 = F.pad(x2, (0, 0, 0, MEAN_ROWS - rows))
    return reduce(x2)[:rows].reshape(*x.shape[:-1], 1)


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last dim, keepdim, with per-row arithmetic that does
    not depend on the number of rows in the call: a decode tick of 8
    lanes, one request alone, a 1-token continuation and a full prefill
    give each row the same bits (the CPU reduction has the property
    already, and padding leaves it so)."""
    return _row_reduce(x, lambda x2: x2.mean(dim=-1))


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, keepdim, padded as :func:`row_mean` is."""
    return _row_reduce(x, lambda x2: x2.sum(dim=-1))


@contextmanager
def sequence_products(on: bool = True):
    """Inside, :func:`by_sequence` runs each whole sequence's products as
    one product per sequence. ``lm.prefill`` enters it for a config with
    ``prefill_per_sequence``; a decode step, a continuation and a
    training forward never run inside it."""
    prev = getattr(_MODE, "on", False)
    _MODE.on = on
    try:
        yield
    finally:
        _MODE.on = prev


def per_sequence(*ts: torch.Tensor) -> bool:
    """Whether products of ``ts`` take one product per sequence: inside
    :func:`sequence_products`, on plain tensors only (a mesh's DTensors
    keep their row blocks)."""
    return getattr(_MODE, "on", False) and all(type(t) in PLAIN for t in ts)


def by_sequence(fn, split: tuple, shared: tuple = (), *, blocked) -> torch.Tensor:
    """The one product site that reads the mode: ``fn(*parts, *shared)``
    once per sequence (dim 0) of the ``split`` tensors, joined on dim 0
    (one sequence: ``fn`` on it whole), where :func:`per_sequence` says
    so, so a row's bits depend on its own sequence only and a long prompt
    costs one launch a product; else ``blocked(*split, *shared)``, the
    row-blocked form."""
    if not per_sequence(*split, *shared):
        return blocked(*split, *shared)
    if split[0].shape[0] == 1:
        return fn(*split, *shared)
    return torch.cat([fn(*parts, *shared) for parts in zip(*(t.split(1) for t in split))])


def seq_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (B, S, K) and a weight w (K, N) as
    :func:`by_sequence` takes it: :func:`matmul`'s blocks of the flattened
    rows, or one product per sequence."""
    return by_sequence(torch.matmul, (x,), (w,), blocked=matmul)
