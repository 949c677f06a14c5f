"""The 16-row block loop of the port's row helpers, and its trip count
under a step analysis.

``flash_attention.rowblock_matmul`` and ``models.layers.lane_blocks`` pad
their rows to whole blocks of 16 and run one call per block
(:func:`row_blocks`), so that a row's bits do not depend on how many rows
share the call. Traced whole, a 65,536-row product is 4,096 calls. Under
an active ``launch.hlo_analysis.StepAnalysis`` (``ACTIVE``, set by
``hlo_analysis.analysing``) the same loop is counted the way the
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

import torch
import torch.nn.functional as F

ROWS = 16  # rows per block (flash_attention.ROW_BLOCK)

# the active StepAnalysis, or None
ACTIVE = None


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


def row_blocks(fn, blocked: tuple, shared: tuple = (), *, dim: int,
               front: int = 0) -> torch.Tensor:
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
