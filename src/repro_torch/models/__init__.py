"""LM models: ``build_model(cfg)`` and the dense decoder-only transformer."""

from .api import Model, build_model  # noqa: F401
