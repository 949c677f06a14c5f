"""remat_scan -- per-layer rematerialization over the block stack
(counterpart of ``repro/models/scan.py``).

The reference hand-writes a VJP around ``lax.scan`` because
``scan(checkpoint(body))`` saved an fp32 copy of the bf16 residual
stack besides the bf16 one. Here each block runs under
``torch.utils.checkpoint`` (non-reentrant): its forward saves nothing
but the block's input carry in its own dtype (bf16 in the residual
stream), and the backward recomputes the block from it before
transposing. The blocks draw no random numbers, so the recomputation
equals the first forward bit for bit, and loss and gradients equal
those of the plain loop.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import rows


def remat_scan(body: Callable[[Any, Any], Any], carry: Any, xs: Iterable) -> Any:
    """``for x in xs: carry = body(carry, x)``, each step checkpointed."""
    for x in xs:
        carry = checkpoint(body, carry, x, use_reentrant=False, preserve_rng_state=False,
                           **rows.checkpoint_kw())
    return carry
