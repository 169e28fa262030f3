"""Roofline terms on a device profile (the port of ``repro.roofline``)."""

from .analysis import RooflineTerms, StepCounts, count_step, roofline  # noqa: F401
