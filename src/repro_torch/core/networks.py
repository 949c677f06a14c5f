"""The paper's evaluation workloads: 6 BNNs (3 MLPs + 3 CNNs), MlBench-style
(counterpart of ``repro/core/networks.py``).

The paper evaluates "6 BNNs (3 convolutional networks and 3 multilayer
perceptrons) with various sizes from MlBench [44]" on MNIST and
CIFAR-10. MlBench (from PRIME [44]) does not publish exact layer lists
in the paper, so we use its standard members: the classic MLPs on MNIST
and LeNet-5 / BinaryNet-VGG-small / VGG-16 on MNIST/CIFAR-10 — the same
suite every CIM-for-BNN paper in this line uses.

Each layer is reduced to the quantities the mappings care about:
``m`` (fan-in = weight-vector length), ``n`` (number of stored weight
vectors = output features/channels) and ``positions`` (input vectors per
inference: 1 for FC, H_out*W_out for conv via im2col). First and last
layers stay high-precision (§II-B), marked ``binary=False``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    name: str
    m: int           # fan-in (vector length driven onto rows)
    n: int           # output vectors (stored columns)
    positions: int   # input vectors per inference (im2col positions)
    binary: bool     # hidden binary layer (XNOR+Popcount) or hi-res edge layer

    @property
    def macs(self) -> int:
        return self.m * self.n * self.positions


@dataclasses.dataclass(frozen=True)
class NetworkDesc:
    name: str
    dataset: str
    layers: tuple[LayerDesc, ...]

    @property
    def macs(self) -> int:
        return sum(l.macs for l in self.layers)


def _mlp(name: str, dims: tuple[int, ...]) -> NetworkDesc:
    layers = []
    for i, (m, n) in enumerate(zip(dims[:-1], dims[1:])):
        edge = i == 0 or i == len(dims) - 2
        layers.append(LayerDesc(f"fc{i}", m=m, n=n, positions=1, binary=not edge))
    return NetworkDesc(name, "MNIST", tuple(layers))


def _conv(name, c_in, c_out, k, out_hw, binary=True) -> LayerDesc:
    return LayerDesc(name, m=c_in * k * k, n=c_out, positions=out_hw * out_hw, binary=binary)


MLP_S = _mlp("MLP-S", (784, 500, 250, 10))
MLP_M = _mlp("MLP-M", (784, 1000, 500, 250, 10))
MLP_L = _mlp("MLP-L", (784, 1500, 1000, 500, 10))

# LeNet-5 on MNIST (CNN-S)
CNN_S = NetworkDesc(
    "CNN-S",
    "MNIST",
    (
        _conv("conv1", 1, 6, 5, 24, binary=False),   # first layer hi-res
        _conv("conv2", 6, 16, 5, 8),
        LayerDesc("fc1", m=400, n=120, positions=1, binary=True),
        LayerDesc("fc2", m=120, n=84, positions=1, binary=True),
        LayerDesc("fc3", m=84, n=10, positions=1, binary=False),
    ),
)

# BinaryNet VGG-small on CIFAR-10 (CNN-M): 2x128C3-P-2x256C3-P-2x512C3-P-1024FC-10
CNN_M = NetworkDesc(
    "CNN-M",
    "CIFAR-10",
    (
        _conv("conv1", 3, 128, 3, 32, binary=False),
        _conv("conv2", 128, 128, 3, 32),
        _conv("conv3", 128, 256, 3, 16),
        _conv("conv4", 256, 256, 3, 16),
        _conv("conv5", 256, 512, 3, 8),
        _conv("conv6", 512, 512, 3, 8),
        LayerDesc("fc1", m=512 * 4 * 4, n=1024, positions=1, binary=True),
        LayerDesc("fc2", m=1024, n=1024, positions=1, binary=True),
        LayerDesc("fc3", m=1024, n=10, positions=1, binary=False),
    ),
)

# VGG-16 on CIFAR-10 (CNN-L)
CNN_L = NetworkDesc(
    "CNN-L",
    "CIFAR-10",
    (
        _conv("conv1", 3, 64, 3, 32, binary=False),
        _conv("conv2", 64, 64, 3, 32),
        _conv("conv3", 64, 128, 3, 16),
        _conv("conv4", 128, 128, 3, 16),
        _conv("conv5", 128, 256, 3, 8),
        _conv("conv6", 256, 256, 3, 8),
        _conv("conv7", 256, 256, 3, 8),
        _conv("conv8", 256, 512, 3, 4),
        _conv("conv9", 512, 512, 3, 4),
        _conv("conv10", 512, 512, 3, 4),
        _conv("conv11", 512, 512, 3, 2),
        _conv("conv12", 512, 512, 3, 2),
        _conv("conv13", 512, 512, 3, 2),
        LayerDesc("fc1", m=512, n=512, positions=1, binary=True),
        LayerDesc("fc2", m=512, n=512, positions=1, binary=True),
        LayerDesc("fc3", m=512, n=10, positions=1, binary=False),
    ),
)

NETWORKS: dict[str, NetworkDesc] = {
    n.name: n for n in (MLP_S, MLP_M, MLP_L, CNN_S, CNN_M, CNN_L)
}
