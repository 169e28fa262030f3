"""Max-pooling fragments (MPF) kernel."""

from . import ops, ref  # noqa: F401
