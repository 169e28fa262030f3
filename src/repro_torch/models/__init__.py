"""LM models: ``build_model(cfg)`` and the decoder-only transformer (dense, MoE,
SSM and hybrid)."""

from .api import Model, build_model  # noqa: F401
