"""Distribution layer on ``torch.distributed`` (counterpart of
``repro/distributed``): sharding rules, activation hints, collectives,
gradient compression, expert-parallel MoE and pipeline parallelism.

  partitioner.py  candidate-list spec inference with divisibility
                  fallback (DP/TP/EP/SP from one rule set); specs to
                  DTensor placements
  hints.py        the mesh context and activation hints
  collectives.py  all-reduce / reduce-scatter / all-gather / ring shift
                  over a process group or a DeviceMesh dim
  compression.py  int8 error-feedback gradient all-reduce
  ep.py           expert-parallel MoE over all_to_all
  pipeline.py     GPipe microbatch schedule over ring shifts
"""

from repro_torch.distributed.partitioner import (
    MeshShape,
    P,
    PartitionSpec,
    batch_specs,
    cache_specs,
    data_axes,
    infer_specs,
    opt_state_specs,
    to_placements,
    validate_specs,
)
