"""Synthetic sharded data pipelines with prefetch."""

from .pipeline import (  # noqa: F401
    Prefetcher,
    SyntheticTokenPipeline,
    SyntheticVolumePipeline,
    TokenPipelineConfig,
    VolumePipelineConfig,
)
