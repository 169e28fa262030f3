"""The paper's primary contribution (ZNNi) as PyTorch modules.

pruned_fft   — pruned forward/inverse FFTs on torch.fft
bias         — the one bias-broadcast rule
direct_conv  — direct 'valid' conv (+ bias)
fft_conv     — FFT convs: data-/task-parallel, cached kernel spectra,
               and the fused conv/pool pairs
overlap_save — overlap-save segmentation, the segment-spectra applies and
               the self-contained segmented conv
mpf          — max-pooling fragments + recombination, plain pooling
primitives   — primitive registry (cost+setup+apply) and CompiledPlan
cost_model   — Tables I/II analytics feeding the planner
planner      — memory-constrained throughput maximization (+ strategies)
pipeline     — the two-stage CPU+GPU pipeline: schedule, stages, placement,
               and its ring over a process group
sublayer     — the GPU + host RAM sub-layers (f' and S splits) and the
               conv with weights sharded over a process group
distributed_inference — patchwise and halo-sharded inference over ranks
staging      — host → device copies on a side CUDA stream
convnet      — parameters, apply_plan and the dense sliding-window oracle
hw           — hardware model constants (H100 SXM target)
"""

from . import (  # noqa: F401
    bias,
    convnet,
    cost_model,
    direct_conv,
    distributed_inference,
    fft_conv,
    hw,
    mpf,
    overlap_save,
    pipeline,
    planner,
    primitives,
    pruned_fft,
    staging,
    sublayer,
)
