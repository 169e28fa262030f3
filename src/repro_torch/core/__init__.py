"""The paper's primary contribution (ZNNi) as PyTorch modules.

pruned_fft   — pruned forward/inverse FFTs on torch.fft
bias         — the one bias-broadcast rule
fft_conv     — FFT conv with cached kernel spectra (+ fused conv/pool pair)
overlap_save — overlap-save segmentation and the segment-spectra applies
mpf          — max-pooling fragments + recombination
primitives   — primitive registry (cost+setup+apply) and CompiledPlan
cost_model   — Tables I/II analytics feeding the planner
planner      — memory-constrained throughput maximization (+ strategies)
pipeline     — the two-stage pipeline's steady-state cadence
convnet      — parameters and the dense sliding-window oracle
hw           — hardware model constants (H100 SXM target)
"""

from . import (  # noqa: F401
    bias,
    convnet,
    cost_model,
    fft_conv,
    hw,
    mpf,
    overlap_save,
    pipeline,
    planner,
    primitives,
    pruned_fft,
)
