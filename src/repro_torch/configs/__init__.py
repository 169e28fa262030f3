"""ConvNet configs: ``ConvLayerSpec``/``ConvNetConfig`` and the ZNNi nets."""

from .base import ConvLayerSpec, ConvNetConfig  # noqa: F401
from .znni_nets import BENCH_NET, N337, N537, N726, N926, ZNNI_NETS, net_by_name  # noqa: F401
