"""The paper's four benchmark ConvNets (ZNNi Table III).

All nets have 80 feature maps per hidden layer and 3 output maps; input is a
single-channel 3D volume (EM connectomics setting).  n926's row-6 "Pool 9^3"
entry in Table III is a typo — the text (§VI-B) says n726/n926 are CPCPCCCC
with 6 conv + 2 pool layers — we follow the text.
"""

from .base import ConvLayerSpec as L
from .base import ConvNetConfig

F = 80  # feature maps (Table III)
OUT = 3  # output maps


def _conv(k: int, f: int = F) -> L:
    return L("conv", k, f)


def _pool(p: int = 2) -> L:
    return L("pool", p)


N337 = ConvNetConfig(
    name="n337",
    in_channels=1,
    layers=(
        _conv(2), _pool(), _conv(3), _pool(), _conv(3), _pool(),
        _conv(3), _conv(3), _conv(3), _conv(3, OUT),
    ),
)

N537 = ConvNetConfig(
    name="n537",
    in_channels=1,
    layers=(
        _conv(4), _pool(), _conv(5), _pool(), _conv(5), _pool(),
        _conv(5), _conv(5), _conv(5), _conv(5, OUT),
    ),
)

N726 = ConvNetConfig(
    name="n726",
    in_channels=1,
    layers=(
        _conv(6), _pool(), _conv(7), _pool(), _conv(7),
        _conv(7), _conv(7), _conv(7, OUT),
    ),
)

N926 = ConvNetConfig(
    name="n926",
    in_channels=1,
    layers=(
        _conv(8), _pool(), _conv(9), _pool(), _conv(9),
        _conv(9), _conv(9), _conv(9, OUT),
    ),
)

ZNNI_NETS = {c.name: c for c in (N337, N537, N726, N926)}

# The CI-sized benchmark net (not a paper net): 8 input channels so layer-0
# input transforms carry real work, small enough that the full strategy
# matrix sweeps in seconds.  Shared by benchmarks/volume_throughput.py and
# repro.tuning.autotune so the tuned-config key "bench-net" means one net.
BENCH_NET = ConvNetConfig(
    name="bench-net",
    in_channels=8,
    layers=(_conv(3, 8), _pool(), _conv(3, 8), _pool(), _conv(3, OUT)),
)


def net_by_name(name: str) -> ConvNetConfig:
    """Resolve a net name: the four Table III nets plus ``bench-net``."""
    if name in (BENCH_NET.name, "bench"):
        return BENCH_NET
    try:
        return ZNNI_NETS[name]
    except KeyError:
        raise ValueError(
            f"unknown net {name!r}; known: {sorted(ZNNI_NETS) + [BENCH_NET.name]}"
        ) from None
