"""Elastic restore (``repro_torch.checkpoint``): a checkpoint of DTensors
written from one mesh restores onto another with the placements asked
for -- (2, 2) -> (4,) and (4,) -> (2, 2) on a 4-rank gloo world, the
reference's test_elastic_restore_across_meshes -- each rank holding its
block and the whole equal to the written tensor; and ``hint`` on a
DTensor redistributes it to the resolved spec (an indivisible dim, or
the model axis with TP off, replicates).
"""

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard

from torch_dist import elastic_worker, run_world

torch.set_num_threads(1)


def test_checkpoint_restores_across_meshes(tmp_path):
    w = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    res = run_world(elastic_worker, 4, tmp_path, {"w": w, "root": tmp_path / "ckpt"})
    for r, out in enumerate(res):
        a = out["2x2_to_4"]
        assert a["step"] == 3 and a["placements"] == (Shard(0),)
        np.testing.assert_array_equal(a["full"].numpy(), w)
        np.testing.assert_array_equal(a["local"].numpy(), w[2 * r:2 * r + 2])
        b = out["4_to_2x2"]
        assert b["step"] == 3 and b["placements"] == (Shard(0), Shard(0))
        np.testing.assert_array_equal(b["full"].numpy(), w)
        np.testing.assert_array_equal(b["local"].numpy(), w[2 * r:2 * r + 2])
        assert out["hint"] == out["expect"] == (Shard(0), Shard(1))
        assert out["hint_indivisible"] == (Replicate(), Replicate())
        assert out["hint_tp_off"] == (Shard(0), Replicate())
