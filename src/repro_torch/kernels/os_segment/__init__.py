"""Fused overlap-save segment pipeline (MAD -> bias -> inverse -> crop)."""

from . import ops, ref  # noqa: F401
