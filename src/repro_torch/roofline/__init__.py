"""Roofline terms on a device profile (the port of ``repro.roofline``)."""

from .analysis import RooflineTerms, roofline  # noqa: F401
