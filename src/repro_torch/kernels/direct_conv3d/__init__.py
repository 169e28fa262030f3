"""Direct 3D 'valid' convolution kernel."""

from . import ops, ref  # noqa: F401
