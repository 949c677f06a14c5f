"""Optimizers and schedules (counterpart of ``repro/optim``).

  adamw.py      AdamW with decoupled weight decay, global-norm clipping,
                an optional factored (Adafactor-style) second moment and
                fp32 master weights, over the reference's stacked trees.
  schedule.py   warmup + cosine decay.
"""

from repro_torch.optim.adamw import (
    OptConfig,
    adamw_begin,
    adamw_init,
    adamw_update,
    global_norm,
)
from repro_torch.optim.schedule import cosine_schedule
