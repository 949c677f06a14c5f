"""Deterministic, step-indexed synthetic data (counterpart of
``repro/data``).

Restart safety is structural: batch(step) is a pure function of
(seed, step, shape), so a resumed job regenerates the exact stream with
no data-loader state in checkpoints.
"""

from repro_torch.data.synthetic import (
    bnn_image_batch,
    frontend_embeds,
    lm_batch,
    make_input_specs,
    token_count,
)
