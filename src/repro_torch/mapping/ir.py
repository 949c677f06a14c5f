"""Mapping IR — the layer view the placement planner compiles from
(counterpart of ``repro/mapping/ir.py``).

The allocator does not care whether a binarized matmul came from a
paper BNN (``core/networks.py::NetworkDesc``) or from an LM's projection
stack (``models/config.py::ModelConfig``); it only needs, per layer, the
quantities a crossbar placement is made of: fan-in ``m`` (rows driven),
fan-out ``n`` (stored weight vectors), how many input vectors stream
through per inference (``positions``), how many identical instances the
model repeats (``count`` — LM layer stacks scan over repeats, so one IR
entry describes all of them), and whether the layer is binary at all
(hi-res edge layers stay off the binary tile fabric, §II-B).

:func:`from_model_config` extracts exactly the projections that
``models/layers.py::dense`` binarizes under ``quant="bnn"``: attention
q/k/v/o and the dense-FFN w1/w3/w2 of each pattern slot. Mixers without
binarized projections (mamba, MoE dispatch) contribute nothing — the
IR mirrors what the execution engines will actually be asked to run.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.networks import LayerDesc, NetworkDesc
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class LayerIR:
    """One (class of) binarized matmul(s) the planner must place."""

    name: str
    m: int              # fan-in: logical input-vector length
    n: int              # fan-out: stored weight vectors (columns)
    count: int = 1      # identical instances (LM scan repeats)
    positions: int = 1  # input vectors per inference (im2col positions)
    binary: bool = True

    def __post_init__(self):
        if self.m < 1 or self.n < 1:
            raise ValueError(f"{self.name}: degenerate layer {self.m}x{self.n}")
        if self.count < 1:
            raise ValueError(f"{self.name}: count must be >= 1, got {self.count}")

    @property
    def macs(self) -> int:
        return self.m * self.n * self.positions * self.count

    def to_layer_desc(self) -> LayerDesc:
        """Bridge to the cost model's layer vocabulary (one instance)."""
        return LayerDesc(
            name=self.name, m=self.m, n=self.n,
            positions=self.positions, binary=self.binary,
        )


@dataclasses.dataclass(frozen=True)
class ModelIR:
    """The ordered layer list one MappingPlan is compiled from."""

    name: str
    source: str                     # "model_config" | "network_desc" | "adhoc"
    layers: tuple[LayerIR, ...]

    @property
    def binary_layers(self) -> tuple[LayerIR, ...]:
        return tuple(l for l in self.layers if l.binary)

    @property
    def macs(self) -> int:
        return sum(l.macs for l in self.layers)

    def layer(self, name: str) -> LayerIR:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(f"no layer {name!r} in IR {self.name}; "
                       f"have: {[l.name for l in self.layers]}")

    def to_network_desc(self) -> NetworkDesc:
        """Expand counts into the cost model's flat layer list."""
        flat = []
        for l in self.layers:
            for i in range(l.count):
                d = l.to_layer_desc()
                if l.count > 1:
                    d = dataclasses.replace(d, name=f"{l.name}[{i}]")
                flat.append(d)
        return NetworkDesc(name=self.name, dataset="-", layers=tuple(flat))


def from_network_desc(net: NetworkDesc) -> ModelIR:
    """Paper BNN workloads (MLP-S ... CNN-L) map one LayerDesc -> LayerIR."""
    return ModelIR(
        name=net.name,
        source="network_desc",
        layers=tuple(
            LayerIR(name=l.name, m=l.m, n=l.n, positions=l.positions, binary=l.binary)
            for l in net.layers
        ),
    )


def from_model_config(cfg: ModelConfig) -> ModelIR:
    """The LM's binarizable projections, one IR entry per pattern slot.

    Matches ``models/layers.py``: under ``quant="bnn"`` the attention
    q/k/v/o denses and the dense-FFN w1/w3/w2 run through the engine
    registry; each pattern slot repeats ``cfg.n_repeats`` times
    (``count``), so a 24-layer qwen1.5-0.5b compiles to 7 IR entries
    covering 168 physical weight matrices.
    """
    d, hd = cfg.d_model, cfg.hd
    layers: list[LayerIR] = []
    for i, kind in enumerate(cfg.pattern):
        slot = f"slot{i}"
        if kind.mixer == "attn":
            layers += [
                LayerIR(f"{slot}.attn.q", m=d, n=cfg.n_heads * hd, count=cfg.n_repeats),
                LayerIR(f"{slot}.attn.k", m=d, n=cfg.n_kv_heads * hd, count=cfg.n_repeats),
                LayerIR(f"{slot}.attn.v", m=d, n=cfg.n_kv_heads * hd, count=cfg.n_repeats),
                LayerIR(f"{slot}.attn.o", m=cfg.n_heads * hd, n=d, count=cfg.n_repeats),
            ]
        if not kind.moe and cfg.d_ff > 0:
            layers += [
                LayerIR(f"{slot}.ffn.w1", m=d, n=cfg.d_ff, count=cfg.n_repeats),
                LayerIR(f"{slot}.ffn.w3", m=d, n=cfg.d_ff, count=cfg.n_repeats),
                LayerIR(f"{slot}.ffn.w2", m=cfg.d_ff, n=d, count=cfg.n_repeats),
            ]
    if not layers:
        raise ValueError(
            f"{cfg.name}: no binarizable projections (pattern has neither "
            "attention nor dense FFN slots) — nothing to place"
        )
    return ModelIR(name=cfg.name, source="model_config", layers=tuple(layers))


def adhoc_layer(m: int, n: int, name: str | None = None) -> ModelIR:
    """A single-matmul IR — what the `tiled` engine compiles on the fly
    when it is handed a weight matrix with no plan covering it."""
    return ModelIR(
        name=name or f"adhoc_{m}x{n}",
        source="adhoc",
        layers=(LayerIR(name=name or f"mm_{m}x{n}", m=m, n=n),),
    )


def to_ir(source) -> ModelIR:
    """Accept a ModelIR, ModelConfig or NetworkDesc."""
    if isinstance(source, ModelIR):
        return source
    if isinstance(source, ModelConfig):
        return from_model_config(source)
    if isinstance(source, NetworkDesc):
        return from_network_desc(source)
    raise TypeError(f"cannot build a mapping IR from {type(source).__name__}")
