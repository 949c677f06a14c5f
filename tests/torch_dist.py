"""Spawned gloo worlds for the distribution tests
(tests/test_torch_{compression,ep,pipeline,elastic}.py).

:func:`run_world` starts ``world_size`` processes
(``launch.mesh.run_local_world``: ``spawn``), each joining a CPU process
group on gloo over a ``FileStore`` in the test's ``tmp_path`` (no TCP
port: the suite runs several workers at once), and runs ``worker(rank,
world_size, payload)``. The world has one deadline: a rank still
running then is killed and the test fails, so a hang costs one test,
not the suite's time limit. Workers
live in this module, which imports no JAX: the tests compute their JAX
oracles in the parent and pass numpy arrays in ``payload``.
"""

from __future__ import annotations

from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import run_local_world

WORLD_TIMEOUT_S = 240


def run_world(worker, world_size: int, tmp_path: Path, payload=None,
              timeout_s: float = WORLD_TIMEOUT_S) -> list:
    """Each rank's ``worker`` result, in rank order (one intra-op thread
    per rank: the suite's workers share the host)."""
    return run_local_world(_one_thread, world_size, workdir=tmp_path,
                           payload=(worker, payload), device="cpu", timeout_s=timeout_s)


def _one_thread(rank: int, world_size: int, payload):
    worker, inner = payload
    torch.set_num_threads(1)
    return worker(rank, world_size, inner)


def moe_from_arrays(arrays: dict):
    """A port ``MoE`` from the reference's ``{router, w1, w3, w2}`` arrays."""
    from repro_torch.models.moe import MoE

    return MoE(*(torch.from_numpy(arrays[n]) for n in ("router", "w1", "w3", "w2")))


def ep_worker(rank: int, world_size: int, payload: dict) -> dict:
    """Expert-parallel MoE on this rank's rows (``payload["x"]`` split over
    the ranks) through ``ep_moe_ffn`` under a 1-D ``model`` mesh, with the
    gradient of the summed squares; then ``lm.prefill`` of a seeded
    smoke model with ``moe_impl="ep_shard_map"`` under the mesh context,
    and the same model's single-process prefill (``moe_ffn``)."""
    import dataclasses

    from repro_torch.distributed import ep
    from repro_torch.distributed.hints import activation_hints
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm

    cfg = payload["cfg"]
    mesh = make_test_mesh((world_size,), ("model",), device="cpu")
    rows = payload["x"].shape[0] // world_size
    x = torch.from_numpy(payload["x"][rank * rows:(rank + 1) * rows]).to(torch.bfloat16)
    p = ep.local_experts(moe_from_arrays(payload["params"]), rank, world_size)
    for n in ("w1", "w3", "w2"):
        getattr(p, n).requires_grad_(True)
    y, aux = ep.ep_moe_ffn(p, x, cfg, mesh)
    y.float().square().sum().backward()
    out = {"y": y.detach().float(), "aux": float(aux), "w1_grad": p.w1.grad.clone()}

    model_cfg = dataclasses.replace(cfg, moe_impl="ep_shard_map")
    model = lm.init_params(torch.Generator().manual_seed(0), model_cfg, device="cpu")
    tokens = torch.from_numpy(payload["tokens"])
    out["single_logits"] = lm.prefill(model, tokens, cfg)[0][rank * 2:(rank + 1) * 2]
    ep.shard_experts_(model, mesh)
    with activation_hints(mesh):
        out["ep_logits"] = lm.prefill(model, tokens[rank * 2:(rank + 1) * 2], model_cfg)[0]
    return out


def collectives_worker(rank: int, world_size: int, payload: dict) -> dict:
    """The collectives over the whole world (values and the ring shift's
    gradient), then ``compressed_all_reduce_mean`` over ranks {0, 1}
    (twice: the second call carries the first's residual)."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.compression import compressed_all_reduce_mean, ef_init

    x = torch.from_numpy(payload["x"][rank])  # (4, 6) per rank
    out = {
        "mean": col.ring_all_reduce_mean(x),
        "scatter": col.reduce_scatter_mean(x, scatter_dim=0),
        "scatter1": col.reduce_scatter_mean(x[:, :4], scatter_dim=1),
        "gather": col.all_gather_dim(x, dim=1),
        "shift": col.ppermute_shift(x, None, 1),
        "shift_back": col.ppermute_shift(x, None, -2),
        "a2a": col.all_to_all(x),
        "transport": col.transport("send_recv", x, col.group_of(None)),
    }
    xg = x.clone().requires_grad_(True)
    (col.ppermute_shift(xg, None, 1) * torch.arange(6.0)).sum().backward()
    out["shift_grad"] = xg.grad
    pair = dist.new_group([0, 1])
    if rank < 2:
        from repro_torch import tree as tree_lib

        grads = tree_lib.tree_map(torch.from_numpy, payload["grads"][rank])
        red, ef = compressed_all_reduce_mean(grads, ef_init(grads), pair)
        red2, ef2 = compressed_all_reduce_mean(grads, ef, pair)
        out.update(reduced=red, ef=ef, reduced2=red2, ef2=ef2)
    dist.barrier()
    return out


def pipeline_worker(rank: int, world_size: int, payload: dict) -> dict:
    """GPipe over the world's ranks: the reference test's tanh stages
    (forward, then gradients), and a smoke tinyllama backbone of one
    block per stage (programmed on ``packed``: forward; latent: forward
    and gradients), each against the sequential run in this process."""
    import dataclasses

    from repro_torch.core.engine import get_engine
    from repro_torch.distributed.pipeline import gpipe
    from repro_torch.models import lm

    out = {}
    ws = torch.from_numpy(payload["ws"])  # (P, L, d, d)

    def tanh_stage(sp, h):
        for i in range(sp.shape[0]):
            h = torch.tanh(h @ sp[i])
        return h

    pipe = gpipe(tanh_stage, None, n_microbatches=4)
    out["tanh"] = pipe(ws[rank], torch.from_numpy(payload["x"]))
    wg = ws[rank].clone().requires_grad_(True)
    pipe(wg, torch.from_numpy(payload["x"])).square().sum().backward()
    out["tanh_grad"] = wg.grad

    cfg = payload["cfg"]
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    h = torch.from_numpy(payload["h"]).to(torch.bfloat16)
    positions = torch.arange(h.shape[1])

    def block_stage(blocks, x):
        return lm.run_blocks(blocks, x, positions, blocks.cfg)

    bnn = dataclasses.replace(cfg, quant="bnn", bnn_engine="packed")
    programmed, _ = lm.program_weights(model, bnn, get_engine("packed"))
    for tag, m, c in (("packed", programmed, bnn), ("latent", model, cfg)):
        stage = torch.nn.ModuleList([m.blocks[rank]])
        stage.cfg = c
        full = torch.nn.ModuleList(m.blocks)
        full.cfg = c
        out[f"{tag}_seq"] = block_stage(full, h)
        out[f"{tag}_pipe"] = gpipe(block_stage, None, n_microbatches=4)(stage, h)
    model.requires_grad_(True)
    full = torch.nn.ModuleList(model.blocks)
    full.cfg = cfg
    block_stage(full, h).float().square().sum().backward()
    mine = [p for p in model.blocks[rank].parameters()]
    out["seq_grads"] = [p.grad.clone() for p in mine]
    for p in model.parameters():
        p.grad = None
    stage = torch.nn.ModuleList([model.blocks[rank]])
    stage.cfg = cfg
    gpipe(block_stage, None, n_microbatches=4)(stage, h).float().square().sum().backward()
    out["pipe_grads"] = [p.grad.clone() for p in mine]
    return out


def elastic_worker(rank: int, world_size: int, payload: dict) -> dict:
    """A checkpoint written from one mesh restores onto another, both
    ways ((2, 2) -> (4,) and (4,) -> (2, 2)); and a DTensor under
    ``hint`` is redistributed to the resolved spec."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.hints import activation_hints, hint
    from repro_torch.distributed.partitioner import P, to_placements
    from repro_torch.launch.mesh import make_test_mesh

    w = torch.from_numpy(payload["w"])  # (8, 6)
    grid = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    line = make_test_mesh((4,), ("data",), device="cpu")
    out = {}
    for name, src, src_spec, dst, dst_spec in (
        ("2x2_to_4", grid, P("data", "model"), line, P("data")),
        ("4_to_2x2", line, P(None, "data"), grid, P(("data", "model"))),
    ):
        root = str(payload["root"]) + "/" + name
        mgr = CheckpointManager(root)
        mgr.save(3, {"w": distribute_tensor(w, src, to_placements(src_spec, src))})
        got, extra = mgr.restore({"w": w}, mesh=dst, placements={"w": to_placements(dst_spec,
                                                                                   dst)})
        out[name] = {"step": extra["step"], "placements": got["w"].placements,
                     "local": got["w"].to_local().clone(), "full": got["w"].full_tensor()}
    x = distribute_tensor(w, grid, (Replicate(), Replicate()))
    with activation_hints(grid):
        out["hint"] = hint(x, "data", "model").placements
        out["hint_indivisible"] = hint(x[:3], "data", None).placements  # 3 % 2 != 0
    with activation_hints(grid, tp=False):
        out["hint_tp_off"] = hint(x, "dp", "model").placements
    out["expect"] = (Shard(0), Shard(1))
    return out


def failing_worker(rank: int, world_size: int, payload) -> int:
    """Rank 1 raises; rank 0 returns."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def hanging_worker(rank: int, world_size: int, payload) -> int:
    """Rank 1 never returns."""
    import time

    while rank == 1:
        time.sleep(1)
    return rank


def meshes_worker(rank: int, world_size: int, payload):
    """The names and sizes of a (2, 2) and a (4,) mesh over the world,
    and the production mesh's refusal of a 4-rank group."""
    from repro_torch.distributed.partitioner import mesh_shape
    from repro_torch.launch.mesh import MeshSizeError, make_production_mesh, make_test_mesh

    try:
        make_production_mesh(device="cpu")
    except MeshSizeError as e:
        refused = str(e)
    return (mesh_shape(make_test_mesh((2, 2), ("data", "model"), device="cpu")),
            mesh_shape(make_test_mesh((4,), ("pod",), device="cpu")), refused)
