"""LM models: ``build_model(cfg)``, the decoder-only transformer (dense, MoE,
SSM and hybrid; the VLM patch frontend) and the encoder-decoder."""

from .api import Model, build_model, params_from_numpy  # noqa: F401
