"""GQA flash-decode attention kernel (the LM serving hot spot)."""

from . import ops, ref  # noqa: F401
