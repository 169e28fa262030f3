"""FFT-domain complex multiply-accumulate over channels (ZNNi's MAD stage)."""

from . import ops, ref  # noqa: F401
