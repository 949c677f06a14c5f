"""Step cells for the dry-run (counterpart of ``repro/launch/steps.py``):
one (arch x shape) cell's step function, its arguments as ``meta``
tensors, their partition specs and DTensor placements, the donation list
and the activation-hint settings.

Everything here is shape-only (``meta`` tensors and the partitioner's
rules), so the dry-run builds 512-rank cells without allocating: jamba's
398 B parameters are never materialized. :func:`trace_cell` is the
counterpart of the reference's ``lower_cell`` and compile: it runs one
rank of the cell's step on ``meta`` DTensor shards on a fake process
group (DTensor's propagation in the role of XLA's SPMD partitioner)
under ``launch/hlo_analysis.py``'s ``StepAnalysis``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch import tree as tree_lib
from repro_torch.data import make_input_specs
from repro_torch.distributed.partitioner import (
    P,
    batch_specs,
    cache_specs,
    data_axes,
    fsdp_batch_axes,
    infer_specs,
    mesh_shape,
    opt_state_specs,
    to_placements,
)
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.train.loop import TrainLoopConfig, make_train_step


def default_opt_cfg(cfg: ModelConfig) -> OptConfig:
    """Factored second moment for 100B+ models: the difference between
    optimizer state fitting a 256-chip pod or not."""
    return OptConfig(factored=cfg.param_count() > 100e9)


def param_shapes(cfg: ModelConfig, *, compute_dtype: bool = True) -> Any:
    """The reference's stacked parameter tree as ``meta`` tensors.
    ``compute_dtype=True`` (production) holds matrices in bf16 (the fp32
    master lives in the optimizer state); 1-D leaves (norm scales,
    biases, SSM A/D/dt) stay fp32. A stacked leaf's leading repeat dim
    counts, so a "matrix" is any leaf of ndim >= 2."""
    fam = encdec_lib if cfg.is_encdec else lm_lib
    tree = fam.param_tree(fam.init_params(torch.Generator(), cfg, device="meta"), device="meta")
    if not compute_dtype:
        return tree

    def cast(t):
        return t.to(torch.bfloat16) if t.ndim >= 2 and t.dtype == torch.float32 else t

    return tree_lib.tree_map(cast, tree)


def opt_shapes(params: Any, opt_cfg: OptConfig) -> dict:
    """The optimizer state of ``params`` (``meta`` in, ``meta`` out)."""
    return adamw_init(params, opt_cfg)


def train_wants_fsdp(cfg: ModelConfig, shape: ShapeConfig, mesh) -> bool:
    """ZeRO-3 batch sharding when the DP-only residual-stream carries
    (per-layer remat saves) pass 4 GiB per device: carry = B S / dp x
    d_model x 2 B x layers (the reference's memory criterion)."""
    if not fsdp_batch_axes(shape.global_batch, mesh):
        return False
    sizes = mesh_shape(mesh).shape
    dp = 1
    for a in data_axes(mesh):
        dp *= sizes[a]
    layers = cfg.n_layers + cfg.n_encoder_layers
    carry = shape.global_batch * shape.seq_len / dp * cfg.d_model * 2 * layers
    return carry > 4 * 2**30


def _prefill_caches(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The caches a prefill of the cell's prompts returns (``meta``): a
    VLM's cover its patches too, an enc-dec's its frames as cross rows."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        return encdec_lib.init_cache(cfg, b, s, src_len=cfg.frontend_len, device="meta")
    extra = cfg.frontend_len if cfg.frontend == "vision" else 0
    return lm_lib.init_cache(cfg, b, s + extra, device="meta")


def _placements(specs: Any, mesh) -> Any:
    return tree_lib.tree_map(lambda sp: to_placements(sp, mesh), specs)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Everything one (arch x shape) cell needs: ``fn`` (the port's step,
    prefill or decode entry point), ``args`` (its arguments' shapes, a
    tuple of ``meta`` trees; ``out`` the outputs' that the specs cover),
    ``in_specs`` / ``out_specs`` and their ``in_placements`` /
    ``out_placements`` on ``mesh`` (a ``MeshShape`` or ``DeviceMesh``),
    ``donate_argnums`` and ``hint_kw`` for ``activation_hints``."""
    specs = make_input_specs(cfg, shape)
    p_shapes = param_shapes(cfg)
    fsdp = shape.kind == "train" and train_wants_fsdp(cfg, shape, mesh)
    p_spec = infer_specs(p_shapes, mesh, fsdp=fsdp)
    rep = P()
    logits_spec = batch_specs(torch.empty((shape.global_batch, 1), device="meta"), mesh)

    if shape.kind == "train":
        opt_cfg = default_opt_cfg(cfg)
        o_shapes = opt_shapes(p_shapes, opt_cfg)
        o_spec = opt_state_specs(p_spec, o_shapes)
        cell = {
            "fn": make_train_step(cfg, opt_cfg, TrainLoopConfig(total_steps=10_000,
                                                                warmup_steps=100)),
            "args": (p_shapes, o_shapes, specs, torch.empty((), dtype=torch.int32,
                                                            device="meta")),
            "in_specs": (p_spec, o_spec, batch_specs(specs, mesh, fsdp=fsdp), rep),
            "out": (p_shapes, o_shapes),
            "out_specs": (p_spec, o_spec),
            "donate_argnums": (0, 1),
            "hint_kw": ({"batch_axes": fsdp_batch_axes(shape.global_batch, mesh), "tp": False}
                        if fsdp else {}),
        }
    elif shape.kind == "prefill":
        if cfg.is_encdec:
            def fn(model, batch):
                return encdec_lib.prefill(model, batch["src_embeds"], batch["tokens"], cfg)
        elif cfg.frontend == "vision":
            def fn(model, batch):
                return lm_lib.prefill(model, batch["tokens"], cfg, batch["extra_embeds"])
        else:
            def fn(model, batch):
                return lm_lib.prefill(model, batch["tokens"], cfg)
        caches = _prefill_caches(cfg, shape)
        cell = {
            "fn": fn,
            "args": (p_shapes, specs),
            "in_specs": (p_spec, batch_specs(specs, mesh)),
            "out": (torch.empty((shape.global_batch, cfg.padded_vocab), device="meta"), caches),
            "out_specs": (logits_spec, cache_specs(caches, mesh)),
            "donate_argnums": (),
            "hint_kw": {},
        }
    else:  # decode: one token against a seq_len-deep cache
        decode = encdec_lib.decode_step if cfg.is_encdec else lm_lib.decode_step

        def fn(model, token, pos, caches):
            return decode(model, token, pos, caches, cfg)

        c_spec = cache_specs(specs["caches"], mesh)
        cell = {
            "fn": fn,
            "args": (p_shapes, specs["token"], specs["pos"], specs["caches"]),
            "in_specs": (p_spec, batch_specs(specs["token"], mesh), rep, c_spec),
            "out": (torch.empty((shape.global_batch, cfg.padded_vocab), device="meta"),
                    specs["caches"]),
            "out_specs": (logits_spec, c_spec),
            "donate_argnums": (3,),
            "hint_kw": {},
        }
    cell["in_placements"] = tuple(_placements(s, mesh) for s in cell["in_specs"])
    cell["out_placements"] = tuple(_placements(s, mesh) for s in cell["out_specs"])
    return cell


# ---------------------------------------------------------------------------
# The traced step (counterpart of the reference's ``lower_cell``)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(mesh):
    """A ``cuda`` ``DeviceMesh`` of ``mesh``'s names and sizes on a fake
    process group of as many ranks, this process rank 0 (``None`` for a
    one-rank mesh: nothing to shard). The group is the process's default
    one while the context lasts and is destroyed after it; a default
    group that already exists raises (the fake one would shadow it).

    The mesh is a CUDA one whether or not this process has a card: the
    shards are ``meta``, and the device type is what DTensor plans its
    collectives by (on a ``cpu`` mesh it moves a shard from one dim to
    another by all-gather and chunk, as gloo has no all-to-all). So a
    trace describes the H100 deployment on any host."""
    import torch.distributed as dist

    ms = mesh_shape(mesh)
    if ms.size == 1:
        yield None
        return
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; trace_cell builds "
                           "its own fake world")
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=ms.size)
    try:
        yield init_device_mesh("cuda", ms.sizes, mesh_dim_names=ms.axis_names)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _greedy_redistribution_costs():
    """While the context lasts DTensor *costs* a candidate strategy's
    redistributions with its greedy planner (mesh dim by mesh dim); the
    redistributions it then runs keep their own plans. For placements
    with strided shards it otherwise searches a graph of states for the
    cheapest plan of every candidate it costs, and on the (2, 16, 16)
    mesh that search takes many minutes per cell. (Private API of
    ``torch.distributed.tensor._redistribute``, restored on exit; absent,
    a warning says the traces keep DTensor's own search.)"""
    import functools
    import sys
    import warnings

    from torch.distributed.tensor import _redistribute as red

    orig = getattr(red, "_gen_transform_infos", None)
    planner = getattr(red, "get_redistribute_planner", None)
    if orig is None or planner is None:
        warnings.warn("this torch has no torch.distributed.tensor._redistribute."
                      "_gen_transform_infos / get_redistribute_planner: redistributions "
                      "are costed by DTensor's own search, which can take minutes per cell")
        yield
        return

    @functools.lru_cache(maxsize=None)
    def greedy(src_spec, dst_spec):
        drp = planner(src_spec.device_mesh, src_spec.tensor_meta)
        return drp.generate_greedy_transform_infos(src_spec, dst_spec)

    def plans(src_spec, dst_spec, use_graph_based_transform=None):
        if sys._getframe(1).f_code.co_name == "redistribute_cost":
            return greedy(src_spec, dst_spec)
        return orig(src_spec, dst_spec, use_graph_based_transform)

    red._gen_transform_infos = plans
    try:
        yield
    finally:
        red._gen_transform_infos = orig


def _cut(cfg: ModelConfig, repeats: int, enc_layers: int | None) -> ModelConfig:
    """``cfg`` with ``repeats`` repeats of its pattern (and ``enc_layers``
    encoder layers)."""
    kw = {"n_layers": repeats * len(cfg.pattern)}
    if enc_layers is not None:
        kw["n_encoder_layers"] = enc_layers
    return dataclasses.replace(cfg, **kw)


def _first_depth(p_shapes: Any, r: int) -> int:
    """The smaller of the two depths to trace: past the depth where the
    largest stacked block leaf outgrows the largest top-level leaf. The
    optimizer's peak follows the largest leaf it updates at a time, so
    the step's peak is linear in the depth only from there on."""
    top = max((t.numel() * t.element_size() for k, t in p_shapes.items()
               if isinstance(t, torch.Tensor)), default=0)
    layer = max((t.numel() * t.element_size() // t.shape[0]
                 for k, sub in p_shapes.items() if isinstance(sub, dict)
                 for t in tree_lib.leaves(sub)), default=1)
    return max(2, min(r - 1, -(-top // layer) + 1))


def _depths(cfg: ModelConfig, p_shapes: Any) -> tuple[list, list]:
    """The cut depths to trace and each trace's coefficient: a count
    linear in the depth, ``c + a R (+ b E)``, is exact at the full depth
    from two neighbouring depths (repeats, and encoder layers), each at
    least two: the optimizer updates a single layer's leaf as a view of
    it, with no stack and no copy back (see also :func:`_first_depth`)."""
    r = cfg.n_repeats
    e = cfg.n_encoder_layers if cfg.is_encdec else None
    r0 = min(r, _first_depth(p_shapes, r))
    e0 = None if e is None else min(e, _first_depth(p_shapes, e))
    cuts, coefs = [(r0, e0)], [1]
    if r > r0:  # X += (r - r0) (X(r0 + 1) - X(r0))
        cuts.append((r0 + 1, e0))
        coefs = [coefs[0] - (r - r0)] + coefs[1:] + [r - r0]
    if e is not None and e > e0:
        cuts.append((r0, e0 + 1))
        coefs = [coefs[0] - (e - e0)] + coefs[1:] + [e - e0]
    return cuts, coefs


def _param_info(fam, model, p_shapes, p_spec) -> dict:
    """id(parameter) -> (dtype, spec) from the full cell's stacked tree:
    a block leaf takes its stack's dtype and spec less the repeat dim."""
    ids = fam._stacked(model, lambda t: torch.tensor(id(t)), lambda t: torch.tensor(id(t)))
    info = {}
    for path, leaf in tree_lib.leaves_with_paths(ids):
        dtype = tree_lib.get(p_shapes, path).dtype
        spec = tuple(tree_lib.get(p_spec, path))
        if leaf.ndim == 0:
            info[int(leaf)] = (dtype, P(*spec))
        else:
            for i in leaf.tolist():
                info[i] = (dtype, P(*spec[1:]))
    return info


def _shard(t: torch.Tensor, spec, mesh, dtype=None) -> torch.Tensor:
    """A ``meta`` stand-in for ``t``: a DTensor of ``spec``'s placements
    on ``mesh`` holding this rank's shard, or (no mesh) a plain tensor."""
    dtype = dtype or t.dtype
    if mesh is None:
        return torch.empty(t.shape, dtype=dtype, device="meta")
    from torch.distributed.tensor import DTensor, Shard

    pl = to_placements(spec, mesh)
    local = list(t.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.shape[i]
    full = torch.empty(t.shape, dtype=dtype, device="meta")
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"), mesh, pl,
                              run_check=False, shape=full.shape, stride=full.stride())


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _trace_depth(cfg: ModelConfig, full: ModelConfig, shape: ShapeConfig, cell: dict, mesh,
                 spec_mesh, unroll_blocks: bool, compute_dtype: bool):
    """One traced step of ``cfg`` (a depth cut of ``full``) under a
    :class:`~repro_torch.launch.hlo_analysis.StepAnalysis`."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.hints import activation_hints
    from repro_torch.launch import hlo_analysis
    from repro_torch.train.loop import family

    fam = family(cfg)
    model = fam.init_params(torch.Generator(), cfg, device="meta")
    p_shapes = cell["args"][0] if compute_dtype else param_shapes(full, compute_dtype=False)
    info = _param_info(fam, model, p_shapes, cell["in_specs"][0])
    train = shape.kind == "train"
    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                dtype, spec = info[id(p)]
                mod._parameters[name] = torch.nn.Parameter(_shard(p, spec, mesh, dtype),
                                                           requires_grad=train)
    specs = make_input_specs(cfg, shape)
    if train:
        opt_cfg = default_opt_cfg(full)
        fn = make_train_step(cfg, opt_cfg, TrainLoopConfig(total_steps=10_000, warmup_steps=100),
                             host_sync=False)
        # the optimizer state as the cell holds it: each leaf (a factored
        # v's row and column statistics too) placed by its own spec
        p_sh = param_shapes(cfg, compute_dtype=compute_dtype)
        o_sh = opt_shapes(p_sh, opt_cfg)
        o_spec = opt_state_specs(infer_specs(p_sh, spec_mesh, fsdp=bool(cell["hint_kw"])), o_sh)
        opt_state = tree_lib.map_with_path(
            lambda path, t: _shard(t, tree_lib.get(o_spec, path), mesh), o_sh)
        batch = tree_lib.map_with_path(
            lambda path, t: _shard(t, tree_lib.get(cell["in_specs"][2], path), mesh), specs)
        args = (model, opt_state, batch, torch.zeros((), dtype=torch.int32, device="meta"))
        extra = [opt_state, batch]
    elif shape.kind == "prefill":
        fn = cell["fn"]
        batch = tree_lib.map_with_path(
            lambda path, t: _shard(t, tree_lib.get(cell["in_specs"][1], path), mesh), specs)
        args, extra = (model, batch), [batch]
    else:
        fn = cell["fn"]
        c_spec = cache_specs(specs["caches"], spec_mesh)
        caches = tree_lib.map_with_path(
            lambda path, t: _shard(t, tree_lib.get(c_spec, path), mesh), specs["caches"])
        token = _shard(specs["token"], cell["in_specs"][1], mesh)
        pos = torch.zeros((), dtype=torch.int32, device="meta")
        args, extra = (model, token, pos, caches), [token, caches]
    arg_tensors = [_local(p) for p in model.parameters()]
    arg_tensors += [_local(t) for t in tree_lib.leaves(extra)]

    an = hlo_analysis.StepAnalysis(unroll_blocks=unroll_blocks)
    an.add_arguments(arg_tensors)
    ctx = activation_hints(mesh, **cell["hint_kw"]) if mesh is not None else contextlib.nullcontext()
    with ctx, implicit_replication(), hlo_analysis.analysing(an):
        out = fn(*args)
    if train:
        outs = [_local(p) for p in model.parameters()] + [_local(t) for t in tree_lib.leaves(opt_state)]
    else:
        outs = [_local(t) for t in tree_lib.leaves(out)]
    an.set_outputs(outs)
    del out, args, model
    return an.finish()


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *, unroll_blocks: bool = False, full_depth: bool = False,
               compute_dtype: bool = True):
    """Trace one rank of the cell's step (the counterpart of the
    reference's ``lower_cell`` + compile): the cell's ``fn`` runs on
    ``meta`` stand-ins of its arguments -- DTensors of the cell's
    placements on a fake world of ``mesh``'s ranks (:func:`fake_world`:
    a CUDA mesh on any host) -- under the
    cell's activation hints and a
    :class:`~repro_torch.launch.hlo_analysis.StepAnalysis`. Returns the
    :class:`~repro_torch.launch.hlo_analysis.Trace` at the full depth,
    extrapolated from two and three repeats of the layer pattern unless
    ``full_depth``; ``unroll_blocks`` traces every 16-row block.
    ``compute_dtype=False`` keeps the parameters fp32 (as the trainer
    holds them; no master copy in the optimizer state) where the
    dry-run's cells hold matrices in bf16 (:func:`param_shapes`).

    The tensors are ``meta``, not ``FakeTensorMode``'s: under that mode
    DTensor's own index bookkeeping for strided shards is faked too and
    asks a fake tensor for its values (``DataDependentOutputException``)."""
    from repro_torch.launch import hlo_analysis

    kernels = (["flash_attention"] if cfg.attn_impl != "jnp" else []) + (
        [f"the {cfg.bnn_engine!r} engine's (fused_bnn_matmul, hamming_matmul)"]
        if cfg.quant == "bnn" and cfg.bnn_engine not in ("", "reference") else [])
    if kernels:
        raise hlo_analysis.KernelInTrace(
            f"{cfg.name} reaches hand-written kernels ({'; '.join(kernels)}): a trace cannot "
            "count them, and counting their plain versions would describe another program")
    with fake_world(mesh) as dmesh, _greedy_redistribution_costs():
        spec_mesh = dmesh if dmesh is not None else mesh
        cell = build_cell(cfg, shape, spec_mesh)
        if full_depth:
            cuts, coefs = [(cfg.n_repeats, cfg.n_encoder_layers if cfg.is_encdec else None)], [1]
        else:
            cuts, coefs = _depths(cfg, param_shapes(cfg, compute_dtype=compute_dtype))
        traces = [_trace_depth(_cut(cfg, r, e), cfg, shape, cell, dmesh, spec_mesh,
                               unroll_blocks, compute_dtype)
                  for r, e in cuts]
    return hlo_analysis.Trace.combine(traces, coefs)
