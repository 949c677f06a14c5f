"""Local worlds and meshes (``repro_torch.launch.mesh``): a spawned world
returns each rank's result; a rank that raises, or one still running at
the deadline, fails the world with a named error and leaves no process
behind; the production meshes' names and sizes are the reference's;
and a 1-D and a 2-D ``DeviceMesh`` over a gloo world carry the names and
sizes the spec rules read.
"""

import pytest
import torch

from repro_torch.distributed.partitioner import MeshShape
from repro_torch.launch import mesh
from torch_dist import failing_worker, hanging_worker, meshes_worker, run_world

torch.set_num_threads(1)


def test_production_mesh_shapes():
    assert mesh.production_mesh_shape() == MeshShape(("data", "model"), (16, 16))
    assert mesh.production_mesh_shape(multi_pod=True) == MeshShape(("pod", "data", "model"),
                                                                    (2, 16, 16))
    assert mesh.production_mesh_shape(multi_pod=True).size == 512


def test_a_failing_rank_fails_the_world(tmp_path):
    with pytest.raises(mesh.WorldError, match="rank 1 fails on purpose"):
        run_world(failing_worker, 2, tmp_path)


def test_a_hung_rank_is_killed_at_the_deadline(tmp_path):
    with pytest.raises(mesh.WorldError, match=r"ranks \[(0, )?1\] killed at the 20 s deadline"):
        run_world(hanging_worker, 2, tmp_path, timeout_s=20)


def test_mesh_shapes_of_device_meshes(tmp_path):
    res = run_world(meshes_worker, 4, tmp_path)
    assert res == [(MeshShape(("data", "model"), (2, 2)), MeshShape(("pod",), (4,)),
                    "mesh (16, 16) needs 256 ranks, the group has 4")] * 4
