#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card; without one (or without the repository's
``src/repro_torch`` beside it) it exits non-zero and prints no result.

Phases, in order; any failure makes the exit code non-zero:

1. Print the card's name and power limit (``nvidia-smi``), then build the
   CUDA kernels from ``src/repro_torch/csrc`` and print the build time and
   ptxas's registers, shared memory and spills of the MAD's, the segment
   conv's, the pool's, the direct conv's and decode attention's kernels,
   and of the two backward kernels (``conv3d_wgrad``, ``mpf_pool_bwd``).
2. Hold each CUDA kernel of the reuse path against its plain PyTorch
   version on the card, at the shapes the served n337 plan gives it (read
   off the compiled plan), with the tolerance printed beside it; time
   kernel, plain version and, where one PyTorch call computes the same
   function, that call (and ``max_pool3d`` at stride 1 beside the pool, a
   yardstick only).  Then the MAD, ``os_segment_conv``, both pools and
   ``conv3d`` (both its kernels) at ragged shapes (no multiple of any
   tile), and ``conv3d`` once past 2^31 outputs, against their plain
   versions.
3. Serve full-width n337 (Table III: 80 maps, 10 layers; random weights
   from a seed) through ``VolumeEngine`` on an ``H100_SXM`` plan with the
   deployed primitives (``overlap_save`` at layer 0, ``fft_cached`` deeper,
   ``mpf`` pools, deep reuse on), three requests of different sizes, with
   ``fuse_os`` off and then on.  Every kernel's launch count is zeroed just
   before each run and read just after; outputs are held against the dense
   oracle (``apply_dense_reference``, TF32 off).  One more serving tick of
   the largest request runs under ``torch.profiler`` (device time by
   kernel).  The largest request is swept once more offline
   (``PlanExecutor.run``) and its counters held against ``predict_counts``.
   Then host-staged streaming (``fuse_os`` on): a volume of six cores
   along x is swept offline dense, then streamed from pinned host memory
   under a ``ram_budget`` between the streaming prediction and the dense
   ledger peak: output bitwise equal, ledger peak <= budget < dense peak
   and equal to ``predict_memory``, counters equal to ``predict_counts``,
   every scope released, each ledger peak printed beside
   ``max_memory_allocated``; then the three requests are served through a
   streaming ``VolumeEngine`` and held against the dense oracle.
   Then other sweep axes and the sharded fleet on that volume V: one reuse
   executor sweeps V on axis 1 and on axis 2 (the per-run override; each
   axis's states are built on first use), counters equal to
   ``predict_counts``, output against the oracle, and axis 2 bitwise equal
   to a natively built ``sweep_axis=2`` executor; one ``VolumeEngine``
   drains V on axes 0, 1 and 2 at batch 3 (so a tick mixes requests),
   twice, every output within the reference's mixed-drain tolerance of
   the oracle and the second drain bitwise equal to the first; a solo
   streaming engine drains V on axes 0 and 1; ``ShardedVolumeEngine`` at
   N = 2 and 3 and at N = 2 on axis 1, each bitwise equal to the solo
   drain, halo bytes as predicted; last, N = 3 with worker 1 down from
   tick 5 (``KillWorker``): evicted, its shard replayed, still bitwise.
   Each run prints its time, vox/s, halo bytes, export and import seconds,
   each worker's ledger peak beside ``max_memory_allocated`` and its
   launch counts.  Every phase before this one passes ``tuned=None``, so
   it runs the knobs it names whatever config is committed.
   Then ``tuned``: (a) the committed config for (this card, n337) must
   load, (b) the three requests served on the deployed plan under
   ``tuned="auto"`` with no explicit knob (``fused_tuned``: the plan's m
   and batch, the config's knobs), held against the oracle, vox/s beside
   the untuned ``fuse_os`` serve and ``tuned_provenance()``; (c) a
   plan-less ``VolumeEngine`` whose m and batch come from the config
   serves three requests shaped for its core, against their oracles,
   with vox/s, ledger peak and ``max_memory_allocated``; (d) a ``--quick``
   tuner run for ``bench-net`` at two candidates, its file written into a
   temporary root and read back.
4. The dense path: the planner's own primitives for n337 on an H100
   (``plan_single``: direct, mpf, overlap_save, mpf, fft_cached, mpf,
   fft_cached ×3, direct), cut only in patch size (m=8, batch 2).  First the
   three kernels it adds (``conv3d`` at layers 0 and 9, ``os_segment_conv``
   at layer 2, ``mpf_pool_window`` in the fused pair at layers 4-5) against
   their plain versions and timed, ``os_segment_conv`` once more under
   ``torch.profiler`` (each pass's kernel time, in launch order), and
   ``cmul_mad`` at the deepest ``fft_cached`` layer's S = 1024 (timed
   beside ``einsum`` and its bound), then three requests served through
   ``VolumeEngine`` with the launch counts zeroed before and read after,
   held against the dense oracle, and one more patch batch under
   ``torch.profiler``: device time by kernel, and the share of the
   batch's wall time the device was busy.  Then the paper's CPU+GPU
   split: ``plan_hetero`` on (the paper's Xeon profile, ``H100_SXM``)
   sweeps the third request offline, each stage on the device class of
   its profile (the host's ``lscpu`` model printed beside the Xeon
   profile), hand-off bytes equal to the plan's, each stage's seconds
   beside its prediction; ``plan_pipeline2`` sweeps it through the
   one-process two-stage loop; both against the dense oracle.  Last, the
   GPU + host RAM sub-layers (the f' and the S split) at the first
   80 -> 80 ``fft_cached`` layer's shapes with operands in pinned host
   memory, against a one-shot conv on the card, timed beside it with the
   bytes they move over the host link.  Then ``distributed``: two gloo
   ranks (this script with ``--rank``) on 127.0.0.1 share the card, with
   a timeout on the group and on their join; any rank's non-zero exit
   fails the phase.  They run pipeline2 of the split's plan as a ring on
   the same volume (against the oracle and the one-process pipeline2,
   saying whether it is bitwise equal), ``gathered_conv`` at the
   sub-layer shapes with f' split in two (against the one-shot conv) and
   ``halo_sharded_apply`` with ``direct`` prims on a pool-free two-conv
   net of 80 maps (against ``apply_plan``), each rank printing seconds
   and the bytes it exchanged through pinned host memory; last, the
   training collectives (``ring_allgather_matmul``, ``all_gather_chunked``,
   ``psum_compressed`` once and 30 times with error feedback,
   ``reduce_scatter_mean``) on card tensors, each against its one-process
   math.
5. The plain-pool path: ``tiled_apply`` on ``bench-net`` with the
   ``use_mpf=False`` plan's primitives (P=4: 64 shifted passes a patch),
   held against the dense oracle.
6. The other three Table III nets (``run_znni_nets``): ``n537``, ``n726``
   and ``n926`` at full width (80 maps, every layer, random weights from a
   seed), each planned on ``H100_SXM`` with the deployed reuse mix
   (``plan_fixed``; m lowered while the planner finds the point
   infeasible, its ``InfeasiblePoint``s printed) and printed beside
   ``plan_single``; ``check_kernels`` on the compiled plan (the layer-0
   segment kernel at k = 4, 6, 8, the MADs and the pool at each net's own
   shapes, untimed); then one volume of two cores along x served through
   ``VolumeEngine`` with ``fuse_os`` and held against the dense oracle,
   with m, batch, vox/s, the ledger peak beside ``max_memory_allocated``
   and the launch counts.  Last, ``plan_hetero(n726, (Xeon, H100_SXM))``
   beside each device's ``plan_single``, priced only.
7. Training on the card (``run_train``), after the ZNNi phases' memory is
   freed:
   a. The backward kernels against their plain versions: the input
      gradient (through the ``conv3d`` kernel) and ``conv3d_wgrad``
      against the plain autograd of ``ref.conv3d`` at n337's training
      shapes (layers 0, 2, 4, 6, 9), ``conv3d_wgrad`` bitwise repeatable,
      then at 19 ragged shapes (five cut at its tile edges);
      ``mpf_pool_bwd`` at layers 1, 3, 5 on tie-free inputs, bitwise equal
      to its plain version and on a second call, and within ``GRAD_TOL``
      of the plain pool's autograd, then at 8 ragged shapes (three cut by
      its tiles on every axis); each timed beside its bound, its plain
      version and cuDNN's ``conv3d_weight`` / ``conv3d_input`` (TF32 off),
      and the forward ``conv3d`` at the same shapes beside cuDNN's
      ``conv3d``.  ``conv3d_wgrad``'s bound is its route's (3xTF32: three
      TF32 products a product at 495 TFLOP/s), printed beside the fp32
      one; no kernel may time under its route's bound.
   b. Full-width n337 (80 maps, 10 layers, ``direct``/``mpf``, random
      weights from seed 0) takes five AdamW steps at m = 2 (input 100³),
      batch 2, on ``SyntheticVolumePipeline`` batches and the example's
      labels, with the launch counts zeroed just before and read just
      after; each step's loss held against the plain versions at the same
      params (within ``LOSS_RTOL``), and step 1's parameter gradients
      (every one present, within ``GRAD_TOL``).  At every step float64
      gradients at the same params (``grads_f64``: cuDNN's conv3d with
      TF32 off, the plain pool) are computed on float64's own ReLU and pool
      branches and on each fp32 forward's (``forward_branches``), and each
      leaf's error is printed for the kernels and the plain versions with
      the count of branches each forward takes apart from float64's; steps
      2-5 hold the kernels to ``|g - g64| <= 1e-4 max|g64| + 1e-6`` on the
      kernels' own branches (``F64_TOL``, ``F64_ATOL``).  Then the plain versions' own five steps from
      the same initial params: step 1 held the same way, the later steps'
      losses printed beside the kernel run's.  Each
      step's host and device time, the allocator peak, the bytes held for
      the backward and each kernel's launches a step are printed; then one
      step each with bf16 and int8 moments, and one step under
      ``torch.profiler``.
   c. A checkpoint written (async) after step 3 is restored into fresh
      objects and steps 4–5 rerun: losses, params and optimizer state
      bitwise equal to the uninterrupted run.
   d. The ``seg-net`` example's 200 steps; its loss must fall.
   e. ``quickstart``, ``serve_volume`` and ``pipeline_inference`` (its
      two ranks) on the card.
8. The LM serving path, after the ZNNi and training phases' memory is
   freed:
   a. ``decode_attn`` against its plain version at the served shapes
      (B 8, S 2048, Hkv 8, G 5, d 128, bf16, one length above S), in f32,
      on a ragged S=600, on one 2048-row sequence, and with lengths on,
      beside and past the split's chunk boundaries and S; timed beside its
      bound and beside PyTorch's ``scaled_dot_product_attention`` (timed
      only).
   b. Full-width, full-depth Qwen2.5-14B (48 layers, bf16, random weights
      from seed 0 drawn on the card) served through ``ServingEngine``
      (8 slots, max_seq 2048): 12 requests, more than the slots, with the
      launch counts zeroed before the drain and read after; then one
      decode tick under ``torch.profiler``.
   c. Every served token's logit within ``LOGIT_TOL`` of its row's maximum
      in a plain ``forward`` (chunked attention, no decode kernel) of
      prompt + generated tokens, and one ``decode_step`` on a fixed cache
      with the kernel against one with the plain version.
   d. The MoE, Mamba2 and local/global archs (``run_lm_archs``):
      ``mamba2-2.7b``, ``phi3-medium-14b``, ``gemma3-27b``,
      ``mixtral-8x7b``, ``grok-1-314b`` and ``jamba-v0.1-52b`` at full
      width, bf16, each at the most layers that fit on the card
      (``fit_depth``; the cut printed), ``decode_attn`` first held
      against its plain version at the arch's served shapes, then served
      (4 slots, 6 requests) and checked as in b–c, its decode tick timed
      on the host and profiled on the device; ``decode_attn`` launched
      once a global-attention layer and tick.  The MoE archs route
      drop-free (capacity factor = experts) and are held against the
      forward routed as the served decode routed, their router logits
      within ``ROUTER_TOL`` of the served ones (``check_lm``).  Then
      one 8-layer jamba pattern served in bf16 and in f32: the router
      gap must close in f32.
   e. The VLM patch frontend, the encoder-decoder and LM training
      (``run_lm_frontends``): ``decode_attn`` held against its plain
      version at qwen2-vl's (B 4, S 512, Hkv 4, G 7, d 128) and whisper's
      (B 4, S 448, Hkv 6, G 1, d 64, lengths across a chunk boundary)
      decode shapes, bf16, timed; full-width, full-depth ``qwen2-vl-7b``
      served as in d (text positions: the engine prefills tokens only),
      then its patch path: ``Model.prefill`` with 8 and with 256 patch
      embeddings and 16 greedy ``decode_step``s, the prefill's logits
      against ``forward``'s and (8 patches only) every token within
      ``LOGIT_TOL`` of its row's maximum in ``forward`` on the grown
      sequence; full-width ``whisper-tiny`` (4 + 4 layers, 1500 frames)
      prefilled request by request with its own frames, packed into 4
      slots of 448 positions, 32 greedy decode steps, each token within
      ``LOGIT_TOL`` of ``forward``, ``decode_attn`` launched once a
      decoder layer and step, the tick timed and profiled.  Then
      ``cross_entropy`` at qwen2-vl's vocabulary (S 600) on f32 and bf16
      logits against a float64 loss and its gradient (``CE_TOL``), and
      ``launch.train.train_loop`` on full-width whisper for 30 steps
      (every loss finite; its fall printed, ``LM_TRAIN`` says why not
      gated), again for 20, then resumed from the step-20 checkpoint to
      30, the losses within ``RESTART_RTOL``, and five steps of a fresh
      run each lowering the loss on its own batch; then the same on the
      reference's own training check (qwen1.5-4b reduced), its loss
      falling.
9. Print the kernels' JSON line (ten entries: the eight Pallas
   counterparts, then ``conv3d_wgrad`` and ``mpf_pool_bwd`` with
   ``replaces`` null), then, as the last line,
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, dense bf16
# and TF32 on the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12

KERNELS = {
    "os_segment": ("src/repro_torch/csrc/os_segment.cu",
                   "src/repro/kernels/os_segment/kernel.py:160"),
    "cmul_mad": ("src/repro_torch/csrc/cmul_mad.cu",
                 "src/repro/kernels/cmul_mad/kernel.py:46"),
    "cmul_mad_bias": ("src/repro_torch/csrc/cmul_mad.cu",
                      "src/repro/kernels/cmul_mad/kernel.py:124"),
    "mpf_pool": ("src/repro_torch/csrc/mpf_pool.cu",
                 "src/repro/kernels/mpf_pool/kernel.py:37"),
    "mpf_pool_window": ("src/repro_torch/csrc/mpf_pool.cu",
                        "src/repro/kernels/mpf_pool/kernel.py:79"),
    "os_segment_conv": ("src/repro_torch/csrc/os_segment.cu",
                        "src/repro/kernels/os_segment/kernel.py:200"),
    "conv3d": ("src/repro_torch/csrc/direct_conv3d.cu",
               "src/repro/kernels/direct_conv3d/kernel.py:52"),
    "decode_attn": ("src/repro_torch/csrc/decode_attn.cu",
                    "src/repro/kernels/decode_attn/kernel.py:61"),
    # the backward kernels of the training path; no Pallas kernel has one
    "conv3d_wgrad": ("src/repro_torch/csrc/conv3d_wgrad.cu", None),
    "mpf_pool_bwd": ("src/repro_torch/csrc/mpf_pool.cu", None),
}
# kernels each serving mode must launch (cmul_mad_bias only serves the
# fused conv+pool pairs: fuse_os on the reuse path, fuse_pairs on the
# dense path)
REACHED = {
    False: ("os_segment", "cmul_mad", "mpf_pool"),
    True: ("os_segment", "cmul_mad", "cmul_mad_bias", "mpf_pool"),
    "dense": ("conv3d", "os_segment_conv", "mpf_pool_window", "cmul_mad_bias",
              "cmul_mad", "mpf_pool"),
    # hetero: the card stage (layers 0-8; layer 9 runs on the host, plain)
    "hetero": ("conv3d", "os_segment_conv", "mpf_pool_window", "cmul_mad_bias",
               "cmul_mad", "mpf_pool"),
    "pipeline2": ("conv3d", "os_segment_conv", "mpf_pool_window", "cmul_mad_bias",
                  "cmul_mad", "mpf_pool"),
    "sublayer": ("cmul_mad",),
    "lm": ("decode_attn",),
    # a training step: the direct conv forward and for the input gradient,
    # the weight gradient, the pool and its gradient
    "train": ("conv3d", "conv3d_wgrad", "mpf_pool", "mpf_pool_bwd"),
}
# end-to-end tolerance of the reference's volume tests
E2E = dict(atol=1e-3, rtol=1e-4)


class Smoke:
    """Collects failures so every phase reports before the exit code."""

    def __init__(self):
        self.failures = []

    def check(self, ok: bool, what: str) -> None:
        print(("ok    " if ok else "FAIL  ") + what, flush=True)
        if not ok:
            self.failures.append(what)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps: int = 5, warmup: int = 1) -> float:
    """Mean milliseconds per call: CUDA events around ``reps`` calls.  The
    calls queue behind a ~10 ms spin of the card, so a call whose host side
    is slower than its kernels is timed by the card, not by the host's
    launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    _sync(device)
    if device.type != "cuda":
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    torch.cuda._sleep(20_000_000)  # clock cycles
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, peak: float = PEAK_FP32):
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and operations over the peak rate of their type (fp32 unless
    given), and which of the two it is."""
    tb, tf = nbytes / PEAK_BYTES, flops / peak
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def _nb(t) -> float:
    return float(t.numel() * t.element_size())


def _close(got, want, atol, rtol):
    import torch

    err = (got - want).abs()
    ok = bool(torch.all(err <= atol + rtol * want.abs()))
    return ok, float(err.max())


def _check_mad(smoke, label, X, W, got, want):
    """Hold a MAD kernel's output against its plain version.  Flat bin 0
    carries the DC bias (b*prod(fft_shape)), far above the other bins, so
    each part gets an atol scaled from its own magnitude; rtol 1e-4.
    Returns the max abs error."""
    bins = X[0, 0].numel()
    g, w = got.reshape(-1, bins), want.reshape(-1, bins)
    atol_dc = 1e-4 * float(w[:, 0].abs().max())
    atol = 1e-4 * float(w[:, 1:].abs().max())
    ok_dc, err_dc = _close(g[:, 0], w[:, 0], atol=atol_dc, rtol=1e-4)
    ok, err = _close(g[:, 1:], w[:, 1:], atol=atol, rtol=1e-4)
    smoke.check(ok and ok_dc,
                f"{label} vs plain, X {tuple(X.shape)} W {tuple(W.shape)}: "
                f"max_abs_err {err:.3e} off bin 0 (atol 1e-4*max|plain| there = "
                f"{atol:.3e}), {err_dc:.3e} at bin 0 (atol {atol_dc:.3e}); rtol 1e-4")
    return max(err, err_dc)


def check_kernels(smoke, ex, plan, device, gen, timed=True):
    """Phase 2: every kernel vs its plain version at the plan's shapes;
    with ``timed``, each timed beside its plain version, bound and library
    call."""
    import torch

    from repro_torch.core.overlap_save import os_input_spectra, tail_segments
    from repro_torch.core.pruned_fft import pruned_rfftn
    from repro_torch.kernels.cmul_mad import ops as cmul_ops
    from repro_torch.kernels.mpf_pool import ops as mpf_ops
    from repro_torch.kernels.os_segment import ops as seg_ops

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    results = {}
    layers, states = ex.compiled.layers, ex.compiled.states
    N = plan.batch

    # os_segment: layer 0's full grid and the strip path's tail form
    spec = layers[0].os_spec
    f0 = plan.choices[0].in_shape[1]
    W0 = states[0]["W"]
    b0 = 0.1 * randn(W0.shape[0])
    F = os_input_spectra(randn(N, f0, *spec.n), spec).contiguous()
    q = tail_segments(spec, ex.core)
    Ft = F[:, spec.n_segments - q:].contiguous()
    tol = E2E
    for form, FF, cols in (("full", F, None), ("tail", Ft, ex.core)):
        got = seg_ops.os_segment_fused(FF, W0, b0, spec, out_cols=cols)
        want = seg_ops.os_segment_fused(FF, W0, b0, spec, out_cols=cols,
                                        use_kernels=False)
        ok, err = _close(got, want, **tol)
        smoke.check(ok, f"os_segment ({form}) vs plain, F {tuple(FF.shape)} "
                        f"W {tuple(W0.shape)}: max_abs_err {err:.3e} "
                        f"(atol {tol['atol']}, rtol {tol['rtol']})")
        if form == "full":
            results["os_segment"] = dict(max_abs_err=err)
    out = seg_ops.os_segment_fused(F, W0, b0, spec)
    A, B, C = spec.fft_shape
    Cb = C // 2 + 1
    NQ, fp, s, oy = N * spec.n_segments, W0.shape[0], spec.seg_core, spec.out[1]
    # The function's own work: the complex MAD over f, then per (segment,
    # output channel) one real 3D inverse FFT of A*B*C points, counted at
    # 2.5 n log2 n operations.  Bytes: F, W, the bias and the output, each
    # once.  The kernel's matmul-DFT inverse does far more (printed as its
    # own work below); the bound does not count it.
    n_fft = A * B * C
    flops = 8.0 * NQ * f0 * fp * A * B * Cb + NQ * fp * 2.5 * n_fft * math.log2(n_fft)
    nbytes = _nb(F) + _nb(W0) + _nb(b0) + _nb(out)
    dft_flops = (8.0 * NQ * fp * s * A * B * Cb + 8.0 * NQ * fp * s * oy * B * Cb
                 + 4.0 * NQ * fp * s * oy * Cb * spec.out[2])
    r = results["os_segment"]
    r["bound_ms"], r["bound_by"] = bound(nbytes, flops)
    r["library_ms"] = None
    if not timed:
        del out, F, Ft
        return _check_mads_and_pool(smoke, ex, plan, device, randn, results, timed)
    r["ms"] = time_ms(lambda: seg_ops.os_segment_fused(F, W0, b0, spec), device)
    r["plain_ms"] = time_ms(
        lambda: seg_ops.os_segment_fused(F, W0, b0, spec, use_kernels=False),
        device, reps=2)
    print(f"os_segment: the kernel's own matmul-DFT inverse is {dft_flops / 1e9:.1f} "
          f"GFLOP ({dft_flops / PEAK_FP32 * 1e3:.3f} ms at the fp32 peak); the "
          f"function needs {flops / 1e9:.1f} GFLOP and {nbytes / 1e9:.3f} GB", flush=True)
    del out, F, Ft
    return _check_mads_and_pool(smoke, ex, plan, device, randn, results, timed)


def _check_mads_and_pool(smoke, ex, plan, device, randn, results, timed):
    """``check_kernels``'s MADs (at the first ``fft_cached`` conv below the
    input) and pool (at the first MPF layer)."""
    import torch

    from repro_torch.core.pruned_fft import pruned_rfftn
    from repro_torch.kernels.cmul_mad import ops as cmul_ops
    from repro_torch.kernels.mpf_pool import ops as mpf_ops

    layers, states = ex.compiled.layers, ex.compiled.states

    # cmul_mad / cmul_mad_bias: the first fft_cached conv below the input
    i2 = next(i for i, pl in enumerate(layers) if pl.prim == "fft_cached")
    S2, f2, n2 = plan.choices[i2].in_shape
    W2 = states[i2]["W"]
    fft2 = layers[i2].fft_shape
    X2 = pruned_rfftn(randn(S2, f2, *n2), fft2)
    b2 = 0.1 * randn(W2.shape[0])
    bins = X2[0, 0].numel()
    fp2 = W2.shape[0]
    for name, call in (
        ("cmul_mad", lambda uk: cmul_ops.cmul_mad(X2, W2, use_kernels=uk)),
        ("cmul_mad_bias", lambda uk: cmul_ops.cmul_mad_bias(
            X2, W2, b2, fft_shape=fft2, use_kernels=uk)),
    ):
        got, want = call(None), call(False)
        err = _check_mad(smoke, name, X2, W2, got, want)
        nbytes = _nb(X2) + _nb(W2) + S2 * fp2 * bins * 8.0
        if name == "cmul_mad_bias":
            nbytes += _nb(b2)
        del got, want
        r = dict(max_abs_err=err)
        r["bound_ms"], r["bound_by"] = bound(nbytes, 8.0 * S2 * f2 * fp2 * bins)
        results[name] = r
        if not timed:
            continue
        r["ms"] = time_ms(lambda: call(None), device)
        r["plain_ms"] = time_ms(lambda: call(False), device, reps=2)
        r["library_ms"] = (
            time_ms(lambda: torch.einsum("si...,ji...->sj...", X2, W2), device)
            if name == "cmul_mad" else None
        )
    del X2

    # mpf_pool: the first MPF layer
    i1 = next(i for i, pl in enumerate(layers) if pl.prim == "mpf")
    S1, f1, n1 = plan.choices[i1].in_shape
    p = layers[i1].pool_size
    x1 = torch.relu(randn(S1, f1, *n1))
    got = mpf_ops.mpf_pool(x1, p)
    want = mpf_ops.mpf_pool(x1, p, use_kernels=False)
    err = float((got - want).abs().max())
    smoke.check(err == 0.0, f"mpf_pool vs plain, x {tuple(x1.shape)} p {p}: "
                            f"max_abs_err {err:.3e} (exact)")
    r = dict(max_abs_err=err, library_ms=None)
    r["bound_ms"], r["bound_by"] = bound(_nb(x1) + _nb(got), float(got.numel()) * (p**3 - 1))
    results["mpf_pool"] = r
    if not timed:
        return results
    r["ms"] = time_ms(lambda: mpf_ops.mpf_pool(x1, p), device)
    r["plain_ms"] = time_ms(lambda: mpf_ops.mpf_pool(x1, p, use_kernels=False),
                            device, reps=2)
    # a bytes-bound yardstick only: max_pool3d at stride 1 computes the
    # sliding max M in another layout, not the fragments in s·p³+o order
    import torch.nn.functional as F

    ms = time_ms(lambda: F.max_pool3d(x1, p, stride=1), device)
    print(f"mpf_pool yardstick: F.max_pool3d(x {tuple(x1.shape)}, {p}, stride=1) "
          f"{ms:.3f} ms (the sliding max, not the fragments; library stays null)",
          flush=True)
    for name, r in results.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        print(f"kernel {name}: {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"library {lib} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})",
              flush=True)
    print("kernels: " + json.dumps(sorted(results)), flush=True)
    return results


def check_ragged(smoke, device, gen):
    """The MAD, the segment conv, the MPF pools and the direct conv at
    shapes that are no multiple of any tile (the served shapes are): the
    MAD at every S, f, f' below with and without the DC bias over 315
    bins, ``os_segment_conv`` with f = 1 and on specs whose A, B, C'' are
    ragged, ``mpf_pool``/``mpf_pool_window`` at p 2 and 3 with odd
    extents that differ per axis (one past a 128-wide z tile), f = 1,
    S = 1 and windows with an uncropped z tail, and ``conv3d`` (both of
    its kernels, and the shapes either side of the launcher's choice) and
    once past 2^31 outputs; tolerances as the served shapes' checks (the
    pools bitwise)."""
    import torch

    from repro_torch.core.fft_conv import precompute_kernel_fft
    from repro_torch.core.overlap_save import plan_overlap_save
    from repro_torch.kernels.cmul_mad import ops as cmul_ops
    from repro_torch.kernels.mpf_pool import ops as mpf_ops
    from repro_torch.kernels.os_segment import ops as seg_ops

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    def crandn(*shape):
        return torch.complex(randn(*shape), randn(*shape))

    sp = (5, 7, 9)
    for S in (1, 5, 37):
        for f in (1, 3, 80):
            for fp in (3, 41):
                X, W, b = crandn(S, f, *sp), crandn(fp, f, *sp), randn(fp)
                fft_shape = (sp[0], sp[1], 2 * (sp[2] - 1))
                for name, call in (
                    ("cmul_mad", lambda uk: cmul_ops.cmul_mad(X, W, use_kernels=uk)),
                    ("cmul_mad_bias", lambda uk: cmul_ops.cmul_mad_bias(
                        X, W, b, fft_shape=fft_shape, use_kernels=uk)),
                ):
                    _check_mad(smoke, f"{name} (ragged)", X, W, call(None), call(False))
    for n, k, seg, f, fp in (((23, 29, 31), (3, 3, 3), 5, 1, 80),
                             ((19, 21, 17), (3, 2, 3), 3, 3, 41)):
        spec = plan_overlap_save(n, k, seg)
        x = torch.relu(randn(2, f, *n))
        W = precompute_kernel_fft(0.3 * randn(fp, f, *k), spec.fft_shape)
        b = randn(fp)
        got = seg_ops.os_segment_conv(x, W, b, spec)
        want = seg_ops.os_segment_conv(x, W, b, spec, use_kernels=False)
        ok, err = _close(got, want, **E2E)
        smoke.check(ok, f"os_segment_conv (ragged) vs plain, x {tuple(x.shape)} W "
                        f"{tuple(W.shape)} fft {spec.fft_shape} Q {spec.n_segments}: "
                        f"max_abs_err {err:.3e} (atol {E2E['atol']}, rtol {E2E['rtol']})")
    for S, f, p, n, window in ((1, 1, 2, (23, 41, 131), None),
                               (2, 3, 2, (35, 19, 67), None),
                               (1, 5, 3, (17, 26, 35), None),
                               (3, 1, 3, (14, 8, 71), None),
                               (1, 1, 2, (33, 27, 36), (31, 27, 33)),
                               (2, 4, 2, (15, 21, 135), (15, 17, 129)),
                               (1, 2, 3, (20, 17, 40), (17, 14, 35))):
        x = torch.relu(randn(S, f, *n))
        if window is None:
            got = mpf_ops.mpf_pool(x, p)
            want = mpf_ops.mpf_pool(x, p, use_kernels=False)
        else:
            got = mpf_ops.mpf_pool_window(x, p, window)
            want = mpf_ops.mpf_pool_window(x, p, window, use_kernels=False)
        err = float((got - want).abs().max())
        name = "mpf_pool" if window is None else f"mpf_pool_window (window {window})"
        smoke.check(err == 0.0 and got.shape == want.shape,
                    f"{name} (ragged) vs plain, x {tuple(x.shape)} p {p}: "
                    f"max_abs_err {err:.3e} (exact)")
    check_ragged_conv3d(smoke, device, gen)


def check_ragged_conv3d(smoke, device, gen):
    """``conv3d`` at every f, f' and k below on odd per-axis extents (a
    (y, z) plane of up to three segments of the plane kernel), S 1 to 3:
    f * k^3 <= 16 takes ``conv3d_plane`` (f 2 with k 2^3 its 16-term
    form), the rest ``conv3d_column``; then one layer-0-like call past 2^31
    outputs, held against the plain version on its first and last three x
    planes (the conv is local along x, so the plain version of x's first
    and last four planes gives them)."""
    import itertools

    import torch

    from repro_torch.kernels.direct_conv3d import ops as conv3d_ops
    from repro_torch.kernels.direct_conv3d import ref as conv3d_ref

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    extents = ((9, 41, 37), (13, 11, 37), (7, 35, 67), (11, 13, 15))
    cases = [(1 + c % 3, f, fp, extents[c % len(extents)], k) for c, (f, fp, k) in
             enumerate(itertools.product((1, 3, 80), (1, 3, 5, 80, 81),
                                         ((2, 2, 2), (3, 3, 3), (3, 2, 1))))]
    cases.append((2, 2, 7, (9, 41, 37), (2, 2, 2)))
    for S, f, fp, n, k in cases:
        x, w = randn(S, f, *n), randn(fp, f, *k)
        got = conv3d_ops.conv3d(x, w)
        want = conv3d_ops.conv3d(x, w, use_kernels=False)
        ok, err = _close(got, want, **E2E)
        kern = ("plane" if conv3d_ref.plane_plan(S, f, fp, n, k) is not None
                else "column")
        smoke.check(ok and got.shape == want.shape,
                    f"conv3d (ragged, {kern}) vs plain, x {tuple(x.shape)} w "
                    f"{tuple(w.shape)}: max_abs_err {err:.3e} (atol {E2E['atol']}, "
                    f"rtol {E2E['rtol']})")
    x, w = randn(1, 1, 302, 302, 302), randn(80, 1, 2, 2, 2)
    got = conv3d_ops.conv3d(x, w)
    _sync(device)
    for label, xs, gs in (("first", x[:, :, :4], got[:, :, :3]),
                          ("last", x[:, :, -4:], got[:, :, -3:])):
        want = conv3d_ops.conv3d(xs.contiguous(), w, use_kernels=False)
        ok, err = _close(gs, want, **E2E)
        smoke.check(ok, f"conv3d past 2^31 outputs ({got.numel()}), x {tuple(x.shape)} "
                        f"w {tuple(w.shape)}: {label} three x planes vs plain: "
                        f"max_abs_err {err:.3e} (atol {E2E['atol']}, rtol {E2E['rtol']})")
    del x, got
    if device.type == "cuda":
        torch.cuda.empty_cache()


def request_shapes(core: int, fov: int):
    """Three requests shaped like the benchmark's volume: the largest has
    three cores and a non-core-aligned remainder on x; one is a single
    patch, which drains mid-batch so its tick mixes two requests."""
    return [
        (3 * core + 3 + fov - 1, 2 * core + fov - 1, 2 * core + fov - 1),
        (core + fov - 1,) * 3,
        (2 * core + fov - 1, core + fov - 1, 2 * core + fov - 1),
    ]


def serve(smoke, label, reached, net, plan, params, vols, dense, device,
          engine=None, need_mixed=True, **engine_kw):
    """Serve three requests through VolumeEngine with the launch counts
    zeroed just before and read just after; hold outputs against the dense
    oracle.  A tick that advances two requests is a mixed tick; one is
    required unless ``need_mixed`` is off."""
    import torch

    from repro_torch import kernels
    from repro_torch.serving import VolumeEngine, VolumeRequest

    if engine is None:
        engine = VolumeEngine(params, net, plan, device=device, **engine_kw)
    reqs = [VolumeRequest(i, v) for i, v in enumerate(vols)]
    for r in reqs:
        engine.submit(r)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    kernels.reset_launch_counts()
    mixed = False
    t0 = time.perf_counter()
    while True:
        before = [len(r._patches) for r in reqs]
        if engine.step() == 0:
            break
        mixed |= sum(b != len(r._patches) for b, r in zip(before, reqs)) > 1
    _sync(device)
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    ex = engine.executor
    vox = sum(float(math.prod(r.out.shape[1:])) for r in reqs)
    peak_alloc = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"serve {label}: {len(reqs)} requests, {engine.ticks} ticks, "
          f"{vox:.0f} voxels in {dt:.3f} s = {vox / dt:.1f} vox/s; "
          f"peak_device_bytes (ledger) {ex.last_stats['peak_device_bytes']:.0f}, "
          f"max_memory_allocated {peak_alloc}; retraces {ex.last_stats['retraces']}; "
          f"launches {json.dumps(counts)}", flush=True)
    smoke.check(all(r.done for r in reqs), f"{label}: every request done")
    if need_mixed:
        smoke.check(mixed, f"{label}: a tick mixed two requests")
    for name in reached:
        smoke.check(counts[name] > 0, f"{label}: {name} launched "
                                      f"{counts[name]} times on the main path")
    for r, want in zip(reqs, dense):
        got = torch.from_numpy(r.out)
        ok, err = _close(got, want, **E2E)
        smoke.check(ok and bool(torch.isfinite(got).all()),
                    f"{label}: request {r.rid} {tuple(r.out.shape)} vs "
                    f"dense oracle: max_abs_err {err:.3e} (atol {E2E['atol']}, "
                    f"rtol {E2E['rtol']}, max|ref| {float(want.abs().max()):.3f})")
    stats = dict(seconds=dt, voxps=vox / dt, voxels=vox, ticks=engine.ticks,
                 mixed=mixed, ledger_peak=ex.last_stats["peak_device_bytes"],
                 max_memory_allocated=peak_alloc)
    return engine, counts, stats


def offline(smoke, ex, vol, dense, device):
    """Phase 3, offline: one ``PlanExecutor.run`` sweep of the largest
    request; counters must equal ``predict_counts``."""
    import torch

    out = ex.run(vol)
    s = ex.last_stats
    c = ex.predict_counts(vol.shape[1:])
    got = (s["os_seg_fft"], s["os_seg_hits"], s["os_mad_segments"],
           s["deep_strip_patches"], s["deep_full_patches"])
    want = (c.seg_fft, c.seg_hits, c.mad_segments, c.strip_patches, c.full_patches)
    print(f"offline run: {s['patches']} patches, {s['batches']} batches, "
          f"{s['seconds']:.3f} s = {s['measured_voxps']:.1f} vox/s; counters {got}, "
          f"predicted {want}; os_fused_segments {s['os_fused_segments']}; "
          f"peak_device_bytes {s['peak_device_bytes']:.0f} "
          f"(predicted {s['predicted_peak_device_bytes']:.0f})", flush=True)
    smoke.check(got == want, "offline counters == predict_counts")
    if device.type == "cuda":
        # os_fused_segments is the os_segment wrapper's own count of the
        # (sample, segment) pairs its launches computed during the sweep
        smoke.check(s["os_fused_segments"] == s["os_mad_segments"],
                    f"os_segment launches computed {s['os_fused_segments']} "
                    f"segments == os_mad_segments {s['os_mad_segments']}")
    ok, err = _close(torch.from_numpy(out), dense, **E2E)
    smoke.check(ok, f"offline output vs dense oracle: max_abs_err {err:.3e}")
    return s


def _released(ex) -> bool:
    return not (ex._sweep_hosts or ex._sweep_slabs or ex._sweeps
                or ex._halo_caches or ex._key_bytes)


def run_streamed(smoke, device, net, plan, params, vols, dense, launches, seed=0):
    """Phase 3, streamed: an offline sweep dense, then host-staged under a
    ``ram_budget``; then the three requests served by a streaming engine.
    Returns the serving stats of each run, the swept volume and its dense
    oracle."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core import planner
    from repro_torch.volume import PlanExecutor

    fov, core = net.field_of_view(), plan.core
    big = request_shapes(core, fov)[0]
    shape = (6 * core + fov - 1, big[1], big[2])
    vol = np.random.default_rng(seed + 5).normal(
        size=(net.in_channels,) + shape).astype(np.float32)
    stats, outs, budget, serve_budget = {}, {}, None, None
    for mode in ("dense", "streamed"):
        kw = {} if mode == "dense" else dict(ram_budget=budget)
        ex = PlanExecutor(params, net, plan, fuse_os=True, tuned=None, device=device,
                          **kw)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
        kernels.reset_launch_counts()
        outs[mode] = ex.run(vol)
        _sync(device)
        counts = kernels.launch_counts()
        s = ex.last_stats
        alloc = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        print(f"sweep {mode}: volume {shape}, {s['patches']} patches, {s['batches']} "
              f"batches, {s['seconds']:.3f} s = {s['measured_voxps']:.1f} vox/s; "
              f"peak_device_bytes (ledger) {s['peak_device_bytes']:.0f} (predicted "
              f"{s['predicted_peak_device_bytes']:.0f}), max_memory_allocated {alloc}; "
              f"launches {json.dumps(counts)}", flush=True)
        stats[f"sweep {mode}"] = dict(seconds=s["seconds"], voxps=s["measured_voxps"],
                                      ledger_peak=s["peak_device_bytes"],
                                      max_memory_allocated=alloc)
        c = ex.predict_counts(shape)
        got = (s["os_seg_fft"], s["os_seg_hits"], s["os_mad_segments"],
               s["deep_strip_patches"], s["deep_full_patches"])
        smoke.check(got == (c.seg_fft, c.seg_hits, c.mad_segments, c.strip_patches,
                            c.full_patches),
                    f"sweep {mode}: counters {got} == predict_counts")
        smoke.check(s["peak_device_bytes"] == s["predicted_peak_device_bytes"],
                    f"sweep {mode}: ledger peak == predict_memory")
        if mode == "dense":
            dense_peak = s["peak_device_bytes"]
            pred = planner.plan_stream_memory(
                net, plan.prims, plan.m_final, shape, batch=plan.batch,
                deep_reuse=True, streaming=True).device_bytes
            budget = (pred + dense_peak) / 2
            print(f"streaming: plan_stream_memory(streaming=True) {pred:.0f} B, dense "
                  f"ledger peak {dense_peak:.0f} B: ram_budget {budget:.0f} B (the "
                  f"streaming saving is {dense_peak - pred:.0f} B)", flush=True)
        else:
            smoke.check(ex.streaming and np.array_equal(outs["dense"], outs["streamed"]),
                        "sweep streamed: output bitwise equal to the dense sweep")
            smoke.check(s["peak_device_bytes"] <= budget < dense_peak,
                        f"sweep streamed: ledger peak {s['peak_device_bytes']:.0f} <= "
                        f"budget {budget:.0f} < dense peak {dense_peak:.0f}")
            smoke.check(_released(ex), "sweep streamed: every sweep scope released")
            for name in REACHED[True]:
                smoke.check(counts[name] > 0, f"sweep streamed: {name} launched "
                                              f"{counts[name]} times")
            for name in launches:
                launches[name] += counts[name]
            # an engine budget that admits the three requests at once, so a
            # tick still mixes two streamed sweeps
            serve_budget = ex._ledger.current + sum(
                ex.sweep_bytes_estimate(ex.bucket_shape(v.shape[1:])) for v in vols)
            if device.type == "cuda":
                # what the allocator's peak holds beyond the ledger (the
                # same sweep once more; its counts are not read)
                allocator_breakdown(lambda: ex.run(vol), device, "one more streamed sweep")
        if device.type == "cuda" and mode == "streamed":
            smoke.check(s["os_fused_segments"] == s["os_mad_segments"],
                        "sweep streamed: os_segment computed every MAD segment")
        del ex
        if device.type == "cuda":
            torch.cuda.empty_cache()
    oracle = dense_oracle(net, params, vol, device)
    ok, err = _close(torch.from_numpy(outs["dense"]), oracle, **E2E)
    smoke.check(ok, f"sweep dense vs dense oracle: max_abs_err {err:.3e}")
    print(f"streamed serve: ram_budget {serve_budget:.0f} B", flush=True)
    engine, counts, stats["serve streamed"] = serve(
        smoke, "streamed", REACHED[True], net, plan, params, vols, dense, device,
        fuse_os=True, ram_budget=serve_budget, tuned=None)
    smoke.check(engine.executor.streaming and _released(engine.executor),
                "streamed serve: executor streaming, every scope released")
    for name in launches:
        launches[name] += counts[name]
    del engine
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return stats, vol, oracle


class KillWorker:
    """Fault hooks of a sharded fleet: worker ``wid`` is down (runs no
    chunk, sends no heartbeat) from tick ``at_tick`` on; every step takes
    one unit of the fleet's synthetic clock."""

    def __init__(self, wid: int, at_tick: int):
        self.wid, self.at_tick = wid, at_tick

    def down(self, wid: int, tick: int) -> bool:
        return wid == self.wid and tick >= self.at_tick

    def step_time(self, wid: int, tick: int) -> float:
        return 1.0


def _time_handoffs(fleet, device):
    """Wrap every worker's ``export_handoff`` and ``import_handoff`` so each
    call's seconds, ended by a synchronize, add up in the returned dict.
    The wrappers close over their executors (a reference cycle: free the
    fleet with ``_free``)."""
    acc = {"export": 0.0, "import": 0.0}

    def timed(fn, key):
        def call(*args, **kwargs):
            _sync(device)
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(device)
            acc[key] += time.perf_counter() - t
            return out
        return call

    for worker in fleet.workers:
        for key in acc:
            name = f"{key}_handoff"
            setattr(worker.executor, name, timed(getattr(worker.executor, name), key))
    return acc


def _reached(smoke, label, counts, launches=None):
    for name in REACHED[True]:
        smoke.check(counts[name] > 0, f"{label}: {name} launched {counts[name]} times")
    if launches is not None:
        for name in launches:
            launches[name] += counts[name]


def _drain(engine, reqs, device):
    """Submit ``reqs``, drain the engine with the launch counts zeroed just
    before and the allocator's peak reset; returns (seconds, counts, peak)."""
    import torch

    from repro_torch import kernels

    for r in reqs:
        engine.submit(r)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    kernels.reset_launch_counts()
    t = time.perf_counter()
    engine.run_until_drained()
    _sync(device)
    dt = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    return dt, kernels.launch_counts(), peak


def _free(device):
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# a tick mixes requests only when one drains mid-batch: at batch 3 the
# volume's x-planes (4 patches each) end on a 1-patch chunk, which the next
# request's first two patches join
MIXED_BATCH = 3
# the reference's tolerance for a mixed-axis drain (tests/test_axis_sweeps.py)
MIXED_TOL = dict(atol=2e-3, rtol=0.0)


def run_axes_fleet(smoke, device, net, plan, params, vol, want, launches):
    """Phase 3, sweep axes and the sharded fleet, on the streamed volume V
    (``want`` is its dense oracle): the per-run axis override, a mixed-axis
    drain, the fleet at N = 2 and 3 and on the y axis, a fault drill.
    Returns the stats of each run."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.serving import ShardedVolumeEngine, VolumeEngine, VolumeRequest
    from repro_torch.volume import PlanExecutor

    shape = tuple(vol.shape[1:])
    vox = float(math.prod(want.shape[1:]))
    stats = {}

    # 1. the per-run override on one reuse executor, then a native axis-2 one
    ex = PlanExecutor(params, net, plan, fuse_os=True, tuned=None, device=device)
    outs = {}
    for axis in (1, 2):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
        kernels.reset_launch_counts()
        outs[axis] = ex.run(vol, sweep_axis=axis)
        _sync(device)
        counts = kernels.launch_counts()
        s = ex.last_stats
        alloc = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        c = ex.predict_counts(shape, sweep_axis=axis)
        got = (s["os_seg_fft"], s["os_seg_hits"], s["os_mad_segments"],
               s["deep_strip_patches"], s["deep_full_patches"])
        label = f"axis override {axis}"
        print(f"{label}: volume {shape} swept on axis {axis} by an axis-0 executor, "
              f"{s['patches']} patches, {s['seconds']:.3f} s = {s['measured_voxps']:.1f} "
              f"vox/s (the axis's lazy state build included); peak_device_bytes "
              f"(ledger) {s['peak_device_bytes']:.0f}, predict_memory "
              f"{ex.predict_memory(shape, sweep_axis=axis).device_bytes:.0f}, "
              f"max_memory_allocated {alloc}; launches {json.dumps(counts)}", flush=True)
        stats[label] = dict(seconds=s["seconds"], voxps=s["measured_voxps"],
                            ledger_peak=s["peak_device_bytes"], max_memory_allocated=alloc)
        smoke.check(got == (c.seg_fft, c.seg_hits, c.mad_segments, c.strip_patches,
                            c.full_patches), f"{label}: counters {got} == predict_counts")
        ok, err = _close(torch.from_numpy(outs[axis]), want, **E2E)
        smoke.check(ok, f"{label}: output vs dense oracle: max_abs_err {err:.3e}")
        _reached(smoke, label, counts, launches)
    smoke.check(sorted(ex._axis_states) == [0, 1, 2] and not ex._sweep_axes,
                "axis override: states built for axes 0, 1, 2; every scope released")
    del ex
    _free(device)
    native = PlanExecutor(params, net, plan, fuse_os=True, sweep_axis=2, tuned=None,
                          device=device)
    out = native.run(vol)
    s = native.last_stats
    print(f"axis native 2: a sweep_axis=2 executor, {s['seconds']:.3f} s = "
          f"{s['measured_voxps']:.1f} vox/s; peak_device_bytes (ledger) "
          f"{s['peak_device_bytes']:.0f} (predicted {s['predicted_peak_device_bytes']:.0f})",
          flush=True)
    stats["axis native 2"] = dict(seconds=s["seconds"], voxps=s["measured_voxps"])
    smoke.check(np.array_equal(out, outs[2]),
                "axis override 2: bitwise equal to a natively built sweep_axis=2 executor")
    del native, outs
    _free(device)

    # 2. one engine, V on axes 0, 1 and 2 in one drain, twice
    mixed = []
    for rep in range(2):
        eng = VolumeEngine(params, net, plan, batch=MIXED_BATCH, fuse_os=True,
                           tuned=None, device=device)
        reqs = [VolumeRequest(a, vol, sweep_axis=a) for a in (0, 1, 2)]
        dt, counts, alloc = _drain(eng, reqs, device)
        ex = eng.executor
        mixed.append([r.out for r in reqs])
        label = f"mixed axes drain {rep + 1}"
        print(f"{label}: V on axes 0, 1, 2 at batch {MIXED_BATCH}, {eng.ticks} ticks, "
              f"{ex.last_stats['mixed_ticks']} mixed; {3 * vox:.0f} voxels in {dt:.3f} s "
              f"= {3 * vox / dt:.1f} vox/s; peak_device_bytes (ledger) "
              f"{ex.last_stats['peak_device_bytes']:.0f}, max_memory_allocated {alloc}; "
              f"launches {json.dumps(counts)}", flush=True)
        stats[label] = dict(seconds=dt, voxps=3 * vox / dt, ticks=eng.ticks,
                            ledger_peak=ex.last_stats["peak_device_bytes"],
                            max_memory_allocated=alloc)
        smoke.check(ex.last_stats["mixed_ticks"] >= 1, f"{label}: a tick mixed requests")
        smoke.check(all(r.done for r in reqs) and _released(ex) and not ex._sweep_axes,
                    f"{label}: every request done, every scope and axis released")
        for r in reqs:
            ok, err = _close(torch.from_numpy(r.out), want, **MIXED_TOL)
            smoke.check(ok, f"{label}: axis {r.sweep_axis} vs dense oracle: max_abs_err "
                            f"{err:.3e} (atol {MIXED_TOL['atol']}, rtol 0)")
        _reached(smoke, label, counts, launches if rep == 0 else None)
        del eng, ex, reqs
        _free(device)
    smoke.check(all(np.array_equal(a, b) for a, b in zip(*mixed)),
                "mixed axes: a second identical drain is bitwise equal")
    del mixed

    # 3-4. the fleet against a solo single-device streaming engine
    solo = VolumeEngine(params, net, plan, fuse_os=True, streaming=True, tuned=None,
                        device=device)
    single = {}
    for axis in (0, 1):
        req = VolumeRequest(0, vol, sweep_axis=axis)
        dt, counts, alloc = _drain(solo, [req], device)
        single[axis] = (req.out, dt)
        label = f"fleet single axis {axis}"
        print(f"{label}: one streaming VolumeEngine, {dt:.3f} s = {vox / dt:.1f} vox/s; "
              f"peak_device_bytes (ledger) {solo.executor.last_stats['peak_device_bytes']:.0f}"
              f", max_memory_allocated {alloc}; launches {json.dumps(counts)}", flush=True)
        stats[label] = dict(seconds=dt, voxps=vox / dt, max_memory_allocated=alloc)
        ok, err = _close(torch.from_numpy(req.out), want, **E2E)
        smoke.check(ok, f"{label}: output vs dense oracle: max_abs_err {err:.3e}")
        _reached(smoke, label, counts, launches)
    del solo
    _free(device)
    runs = (("fleet N=2", 2, 0, None), ("fleet N=3", 3, 0, None),
            ("fleet N=2 axis 1", 2, 1, None),
            ("fault drill N=3", 3, 0, KillWorker(1, at_tick=5)))
    for label, n, axis, hooks in runs:
        fleet = ShardedVolumeEngine(params, net, plan, n_workers=n, fuse_os=True,
                                    sweep_axis=axis, fault_hooks=hooks, tuned=None,
                                    device=device)
        handoff = _time_handoffs(fleet, device)
        req = VolumeRequest(0, vol)
        dt, counts, alloc = _drain(fleet, [req], device)
        st = fleet.last_stats
        ref_out, ref_dt = single[axis]
        peaks = [w.executor._ledger.peak for w in fleet.workers]
        print(f"{label}: {st['ticks']} ticks, {dt:.3f} s = {vox / dt:.1f} vox/s (single "
              f"device {ref_dt:.3f} s = {vox / ref_dt:.1f}); halo_bytes_in "
              f"{st['halo_bytes_in']} (predicted {st['predicted_halo_bytes_in']}), "
              f"exchanged {st['halo_exchange_bytes']} B, export {handoff['export']:.4f} s, "
              f"import {handoff['import']:.4f} s; redispatches {st['redispatches']}, "
              f"duplicates_dropped {st['duplicates_dropped']}; worker ledger peaks "
              f"{[round(p) for p in peaks]}, sum {sum(peaks):.0f}, max_memory_allocated "
              f"{alloc}; launches {json.dumps(counts)}", flush=True)
        stats[label] = dict(seconds=dt, voxps=vox / dt, ticks=st["ticks"],
                            halo_exchange_bytes=st["halo_exchange_bytes"],
                            export_seconds=handoff["export"],
                            import_seconds=handoff["import"],
                            worker_ledger_peaks=peaks, max_memory_allocated=alloc)
        smoke.check(req.done and np.array_equal(req.out, ref_out),
                    f"{label}: bitwise equal to the single-device engine")
        smoke.check(st["halo_exchange_bytes"] > 0, f"{label}: the boundary handed off")
        if hooks is None:
            smoke.check(st["halo_bytes_in"] == st["predicted_halo_bytes_in"],
                        f"{label}: halo_bytes_in == predicted_halo_bytes_in")
            smoke.check(st["redispatches"] == st["duplicates_dropped"] == 0,
                        f"{label}: no redispatch, no duplicate")
        else:
            pred = st["predicted_halo_bytes_in"]
            smoke.check(st["redispatches"] >= 1 and st["duplicates_dropped"] >= 1,
                        f"{label}: worker {hooks.wid} evicted, its shard replayed")
            # the replay imports worker 1's start package once more
            smoke.check(st["halo_exchange_bytes"] == sum(pred) + pred[hooks.wid],
                        f"{label}: exchanged bytes == predicted + one more delivery "
                        f"of worker {hooks.wid}'s boundary")
        _reached(smoke, label, counts, launches)
        del fleet, req
        _free(device)
    return stats


def run_tuned(smoke, device, net, plan, params, vols, dense, launches, serving, seed=0):
    """Phase 3, tuned: the committed config for this card, served two ways
    under ``tuned="auto"`` with no explicit knob, then a short tuner run."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving import VolumeEngine
    from repro_torch.tuning import (
        autotune,
        load_tuned_config,
        normalize_device_kind,
        save_tuned_config,
    )

    # (a) the committed config for (this card, the net); never skipped
    kind = normalize_device_kind(device=device)
    cfg = load_tuned_config(net.name, device=device)
    smoke.check(cfg is not None and cfg.device_kind == kind and cfg.net == net.name,
                f"tuned: the committed config for ({kind}, {net.name}) loads: {cfg}")
    if cfg is None:
        return {}
    rows = {}
    reached = REACHED[bool(cfg.fuse_os)]
    # (b) fused_tuned: the deployed plan, its knobs from the config
    engine, counts, rows["fused_tuned"] = serve(
        smoke, "fused_tuned", reached, net, plan, params, vols, dense, device,
        tuned="auto")
    ex = engine.executor
    smoke.check(ex.tuned == cfg and (ex.m, ex.batch) == (plan.m_final, plan.batch)
                and ex.fuse_os == bool(cfg.fuse_os) and ex.fuse_pairs == bool(cfg.fuse_pairs),
                f"fused_tuned: the plan's m {ex.m} and batch {ex.batch}, the config's "
                f"fuse_os {ex.fuse_os} and fuse_pairs {ex.fuse_pairs}")
    rows["fused_tuned"]["tuned_config"] = ex.tuned_provenance()
    print(f"fused_tuned: {rows['fused_tuned']['voxps']:.1f} vox/s beside the untuned "
          f"fuse_os serve's {serving['fuse_os=True']['voxps']:.1f}; tuned_provenance "
          f"{json.dumps(ex.tuned_provenance())}", flush=True)
    for name in launches:
        launches[name] += counts[name]
    del engine, ex
    _free(device)

    # (c) plan-less: m and batch from the config too
    fov = net.field_of_view()
    core = cfg.m * net.total_pooling()
    rng = np.random.default_rng(seed + 7)
    tvols = [rng.normal(size=(net.in_channels,) + s).astype(np.float32)
             for s in request_shapes(core, fov)]
    tdense = [dense_oracle(net, params, v, device) for v in tvols]
    _free(device)
    engine = VolumeEngine(params, net, prims=autotune._os_prims(net), tuned="auto",
                          device=device)
    ex = engine.executor
    smoke.check(ex.tuned == cfg and (ex.m, ex.batch) == (cfg.m, cfg.batch),
                f"tuned plan-less: m {ex.m} and batch {ex.batch} from the config")
    engine, counts, rows["tuned plan-less"] = serve(
        smoke, "tuned plan-less", reached, net, None, params, tvols, tdense, device,
        engine=engine, need_mixed=False)
    for name in launches:
        launches[name] += counts[name]
    del engine, ex, tvols, tdense
    _free(device)

    # (d) a short tuner run on this card, written into a temporary root
    with tempfile.TemporaryDirectory() as root:
        kernels.reset_launch_counts()
        t = time.perf_counter()
        winner, results, meta = autotune.autotune_net(
            "bench-net", shortlist=2, quick=True, device=device)
        dt = time.perf_counter() - t
        counts = kernels.launch_counts()
        path = save_tuned_config(winner, root=Path(root))
        back = load_tuned_config("bench-net", device=device, root=Path(root))
        print(f"tuner --quick: bench-net, {len(meta['shortlist'])} of {len(meta['grid'])} "
              f"candidates in {dt:.1f} s: {json.dumps(results)}; predicted "
              f"({meta['profile']}) {json.dumps(meta['predicted'])}; out of memory "
              f"{meta['oom']}; winner {winner}; launches {json.dumps(counts)}", flush=True)
        smoke.check(len(results) == 2 and set(meta["shortlist"]) <= set(meta["grid"]),
                    "tuner --quick: two candidates measured, the shortlist in the grid")
        smoke.check(back == winner and path.name == f"{kind}__bench-net.json",
                    f"tuner --quick: {path.name} round-trips through load_tuned_config")
        for name in REACHED[False]:
            smoke.check(counts[name] > 0, f"tuner --quick: {name} launched "
                                          f"{counts[name]} times")
    rows["tuner quick"] = dict(seconds=dt, results=results)
    _free(device)
    return rows


def peak_live_blocks(events, baseline: int):
    """Replay an allocator trace (``torch.cuda.memory._snapshot()``'s
    ``device_traces`` entry) to the moment allocated bytes peak.  Returns
    (peak bytes, {site: (blocks, bytes)} of the blocks allocated in the
    trace and live then); ``baseline`` is the bytes allocated before it."""
    live, cur, peak, at_peak = {}, baseline, baseline, {}
    for e in events:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], _alloc_site(e.get("frames", ())))
            cur += e["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif e["action"] == "free_requested":
            size, _ = live.pop(e["addr"], (e["size"], None))
            cur -= size
    sites = {}
    for size, site in at_peak.values():
        n, b = sites.get(site, (0, 0))
        sites[site] = (n + 1, b + size)
    return peak, sites


def _alloc_site(frames) -> str:
    """The innermost frame in the port's package, else the innermost.  The
    caller's frame (this script) is the outermost, which orders the list."""
    frames = list(frames)
    own = [i for i, f in enumerate(frames) if f["filename"].endswith("chip_smoke.py")]
    if own and own[0] == 0:
        frames.reverse()
    for f in frames:
        if "repro_torch" in f["filename"]:
            path = f["filename"][f["filename"].rfind("repro_torch"):]
            return f"{path}:{f['line']} ({f['name']})"
    return f"{frames[0]['filename']}:{frames[0]['line']}" if frames else "no frames"


def allocator_breakdown(fn, device, label, top=12):
    """Run ``fn`` with the CUDA allocator's history on and print what is
    live at its allocated-bytes peak, by allocating line of the port."""
    import torch

    _sync(device)
    baseline = torch.cuda.memory_allocated(device)
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python", max_entries=1_000_000)
    try:
        fn()
        _sync(device)
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    peak, sites = peak_live_blocks(snap["device_traces"][device.index or 0], baseline)
    print(f"allocator: {label}: {baseline} B allocated before, peak {peak} B; live at "
          f"the peak beyond the blocks held before:", flush=True)
    for site, (n, b) in sorted(sites.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"allocator: {b:14d} B in {n:4d} blocks from {site}", flush=True)
    return peak


def dense_oracle(net, params, vol, device):
    import torch

    from repro_torch.core import convnet

    return convnet.apply_dense_reference(
        params, net, torch.from_numpy(vol)[None].to(device))[0].cpu()

def check_dense_kernels(smoke, ex, plan, params, device, gen, hw):
    """Phase 4, kernels: the three the dense path adds, at its shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.cost_model import conv_cost
    from repro_torch.core.pruned_fft import pruned_rfftn
    from repro_torch.kernels.cmul_mad import ops as cmul_ops
    from repro_torch.kernels.direct_conv3d import ops as conv3d_ops
    from repro_torch.kernels.mpf_pool import ops as mpf_ops
    from repro_torch.kernels.os_segment import ops as seg_ops

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    def cudnn(fn):
        # the library yardstick in full fp32, like the dense oracle
        def call():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return fn()
        return call

    layers, states, choices = ex.compiled.layers, ex.compiled.states, plan.choices
    results = {}

    # conv3d at both direct layers: layer 0 (f=1, f'=80, k=2) and the last
    # (f=80, f'=3, k=3); its ms, plain ms, bound and library ms are the sums
    # over the two call sites, bound_by that of the call with the larger bound
    r = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    worst = (0.0, "bytes")
    for i, pl in enumerate(layers):
        if pl.prim != "direct":
            continue
        S, f, n = choices[i].in_shape
        w = params[i][0]
        x = randn(S, f, *n)
        got = conv3d_ops.conv3d(x, w)
        want = conv3d_ops.conv3d(x, w, use_kernels=False)
        ok, err = _close(got, want, **E2E)
        smoke.check(ok, f"conv3d (layer {i}) vs plain, x {tuple(x.shape)} w "
                        f"{tuple(w.shape)}: max_abs_err {err:.3e} (atol {E2E['atol']}, "
                        f"rtol {E2E['rtol']})")
        k3 = math.prod(w.shape[2:])
        flops = 2.0 * got.numel() * f * k3
        bms, bb = bound(_nb(x) + _nb(w) + _nb(got), flops)
        ms = time_ms(lambda: conv3d_ops.conv3d(x, w), device)
        pms = time_ms(lambda: conv3d_ops.conv3d(x, w, use_kernels=False), device, reps=2)
        # cuDNN computes the same function: no bias (direct_conv adds it after)
        lms = time_ms(cudnn(lambda: F.conv3d(x, w)), device)
        print(f"conv3d layer {i}: {ms:.3f} ms, plain {pms:.3f} ms, cuDNN conv3d "
              f"{lms:.3f} ms, bound {bms:.3f} ms ({bb})", flush=True)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += pms
        r["bound_ms"] += bms
        r["library_ms"] += lms
        worst = max(worst, (bms, bb))
        del x, got, want
    r["bound_by"] = worst[1]
    results["conv3d"] = r

    # os_segment_conv: the overlap_save layer's self-contained apply
    i2 = next(i for i, pl in enumerate(layers) if pl.prim == "overlap_save")
    spec = layers[i2].os_spec
    S2, f2, n2 = choices[i2].in_shape
    W2, b2 = states[i2]["W"], params[i2][1]
    x2 = torch.relu(randn(S2, f2, *n2))
    got = seg_ops.os_segment_conv(x2, W2, b2, spec)
    want = seg_ops.os_segment_conv(x2, W2, b2, spec, use_kernels=False)
    ok, err = _close(got, want, **E2E)
    A, B, C = spec.fft_shape
    print(f"os_segment_conv spec: seg_core {spec.seg_core}, seg_extent "
          f"{spec.seg_extent}, Q {spec.n_segments}, fft {spec.fft_shape}", flush=True)
    smoke.check(ok, f"os_segment_conv vs plain, x {tuple(x2.shape)} W {tuple(W2.shape)}: "
                    f"max_abs_err {err:.3e} (atol {E2E['atol']}, rtol {E2E['rtol']})")
    NQ, fp = S2 * spec.n_segments, W2.shape[0]
    n_fft = A * B * C
    # the function's work: the complex MAD, one forward FFT per (segment,
    # input channel) and one inverse per (segment, output channel) at
    # 2.5 n log2 n; bytes: x, W, the bias and the output, each once
    flops = (8.0 * NQ * f2 * fp * W2[0, 0].numel()
             + NQ * (f2 + fp) * 2.5 * n_fft * math.log2(n_fft))
    r = dict(max_abs_err=err)
    r["bound_ms"], r["bound_by"] = bound(_nb(x2) + _nb(W2) + _nb(b2) + _nb(got), flops)
    r["ms"] = time_ms(lambda: seg_ops.os_segment_conv(x2, W2, b2, spec), device)
    r["plain_ms"] = time_ms(
        lambda: seg_ops.os_segment_conv(x2, W2, b2, spec, use_kernels=False),
        device, reps=2)
    w2 = params[i2][0]
    r["library_ms"] = time_ms(cudnn(lambda: F.conv3d(x2, w2, b2)), device)
    results["os_segment_conv"] = r
    # what the planner's cost model predicts for this layer on this card
    k2 = layers[i2].kernel_size
    model = {prim: conv_cost(prim, S2, f2, fp, tuple(n2), k2[0]).time(hw) * 1e3
             for prim in ("overlap_save", "direct")}
    print(f"os_segment_conv: the cost model predicts overlap_save {model['overlap_save']:.3f} "
          f"ms and direct {model['direct']:.3f} ms at these shapes on {hw.name}; measured "
          f"{r['ms']:.3f} ms and cuDNN's direct {r['library_ms']:.3f} ms", flush=True)
    # where its time goes: each pass of each sample chunk, in launch order
    device_profile(lambda: seg_ops.os_segment_conv(x2, W2, b2, spec), device,
                   f"os_segment_conv, x {tuple(x2.shape)}", top=12, timeline=True)
    del x2, got, want

    # cmul_mad at the deepest fft_cached layer's S (operation-bound there),
    # beside einsum: the second line of its row
    i6 = next(i for i, pl in enumerate(layers)
              if pl.prim == "fft_cached" and choices[i].in_shape[0] >= 1024)
    S6, f6, n6 = choices[i6].in_shape
    W6 = states[i6]["W"]
    X6 = pruned_rfftn(randn(S6, f6, *n6), layers[i6].fft_shape)
    bins = X6[0, 0].numel()
    err = _check_mad(smoke, f"cmul_mad (layer {i6})", X6, W6,
                     cmul_ops.cmul_mad(X6, W6),
                     cmul_ops.cmul_mad(X6, W6, use_kernels=False))
    flops = 8.0 * S6 * f6 * W6.shape[0] * bins
    bms, bb = bound(_nb(X6) + _nb(W6) + S6 * W6.shape[0] * bins * 8.0, flops)
    ms = time_ms(lambda: cmul_ops.cmul_mad(X6, W6), device)
    pms = time_ms(lambda: cmul_ops.cmul_mad(X6, W6, use_kernels=False), device, reps=2)
    lms = time_ms(lambda: torch.einsum("si...,ji...->sj...", X6, W6), device)
    print(f"kernel cmul_mad (layer {i6}, S {S6}): X {tuple(X6.shape)} W {tuple(W6.shape)}: "
          f"{ms:.3f} ms, plain {pms:.3f} ms, einsum {lms:.3f} ms, bound {bms:.3f} ms "
          f"({bb}), {flops / ms / 1e6:.1f} GFLOP/s = {100 * flops / ms * 1e3 / PEAK_FP32:.1f}% "
          f"of the fp32 peak; max_abs_err {err:.3e}", flush=True)
    del X6

    # mpf_pool_window: the pool of the fused fft_cached+mpf pair, over the
    # inverse's output uncropped on the last axis
    i4 = next(i for i, pl in enumerate(layers)
              if pl.prim == "fft_cached" and i + 1 < len(layers)
              and layers[i + 1].prim == "mpf")
    S4, _, n4 = choices[i4].in_shape
    k4 = layers[i4].kernel_size
    window = tuple(ni - ki + 1 for ni, ki in zip(n4, k4))
    p = layers[i4 + 1].pool_size
    x4 = randn(S4, params[i4][0].shape[0], window[0], window[1],
               layers[i4].fft_shape[2])
    got = mpf_ops.mpf_pool_window(x4, p, window)
    want = mpf_ops.mpf_pool_window(x4, p, window, use_kernels=False)
    err = float((got - want).abs().max())
    smoke.check(err == 0.0, f"mpf_pool_window vs plain, x {tuple(x4.shape)} window "
                            f"{window} p {p}: max_abs_err {err:.3e} (exact)")
    r = dict(max_abs_err=err)
    win_bytes = 4.0 * x4.shape[0] * x4.shape[1] * math.prod(window)
    r["bound_ms"], r["bound_by"] = bound(win_bytes + _nb(got),
                                         float(got.numel()) * (p**3 - 1))
    r["ms"] = time_ms(lambda: mpf_ops.mpf_pool_window(x4, p, window), device)
    r["plain_ms"] = time_ms(
        lambda: mpf_ops.mpf_pool_window(x4, p, window, use_kernels=False), device, reps=2)
    r["library_ms"] = None
    print("mpf_pool_window: library none — no single PyTorch call yields all p³ "
          "pooling fragments in the s·p³+o batch order (max_pool3d gives one "
          "offset a call)", flush=True)
    results["mpf_pool_window"] = r
    del x4, got, want
    for name, r in results.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        print(f"kernel {name}: {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"library {lib} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})",
              flush=True)
    return results


def run_dense(smoke, device, net, params, hw, m, batch, launches, serving, gen,
              prims=None):
    """Phase 4: the planner's own dense plan for the net (or ``prims``), at
    fragment size ``m``: its kernels, then three served requests."""
    import numpy as np
    import torch

    from repro_torch.core import convnet, planner
    from repro_torch.serving import VolumeEngine

    own = planner.plan_single(net, hw)
    print(f"planner's own plan: {net.name} m {own.m_final} batch {own.batch} "
          f"n_in {own.n_in} core {own.core} predicted {own.throughput:.1f} vox/s "
          f"prims {own.prims}", flush=True)
    fov = net.field_of_view()
    core = m * net.total_pooling()
    shapes = request_shapes(core, fov)
    plan = planner.plan_fixed(net, hw, prims or own.prims, m=m, batch=batch)
    if plan is None:
        smoke.check(False, "plan_fixed found the dense configuration infeasible")
        return {}
    print(f"dense plan: core {plan.core} n_in {plan.n_in} batch {plan.batch} "
          f"prims {plan.prims}; layer inputs "
          f"{[(c.prim, c.in_shape[0], c.in_shape[1]) for c in plan.choices]}", flush=True)
    engine = VolumeEngine(params, net, plan, tuned=None, device=device)
    smoke.check(not engine.executor._os_reuse and engine.executor.fuse_pairs,
                "dense plan: dense walk with fused conv+pool pairs")
    results = check_dense_kernels(smoke, engine.executor, plan, params, device, gen, hw)
    rng = np.random.default_rng(1)
    vols = [rng.normal(size=(net.in_channels,) + s).astype(np.float32) for s in shapes]
    dense = [
        convnet.apply_dense_reference(
            params, net, torch.from_numpy(v)[None].to(device))[0].cpu()
        for v in vols
    ]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    engine, counts, serving["dense"] = serve(
        smoke, "dense", REACHED["dense"], net, plan, params, vols, dense, device,
        engine=engine,
    )
    for name in launches:
        launches[name] += counts[name]
    profile_batch(engine, vols[0], device)
    del engine
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    splits = run_split(smoke, device, net, params, vols[2], dense[2], launches, serving)
    run_sublayers(smoke, device, plan, params, gen, launches, serving)
    print(f"split and sub-layer phases: {time.perf_counter() - t:.1f} s", flush=True)
    _free(device)
    t = time.perf_counter()
    serving["distributed"] = run_distributed(
        smoke, device, net, params, vols[2], dense[2], splits.get("pipeline2"),
        serving.get("pipeline2", {}).get("seconds", float("nan")), launches)
    print(f"distributed phase: {time.perf_counter() - t:.1f} s", flush=True)
    return results


def profile_batch(engine, vol, device):
    """One full dense patch batch under torch.profiler (after a warm-up
    batch), and the direct conv's share of its device time."""
    import numpy as np

    from repro_torch.volume.tiler import extract_patch

    ex = engine.executor
    tiling = ex.tiling_for(vol.shape[1:])
    xs = np.stack([extract_patch(vol, s, tiling.extent)
                   for s in tiling.patches[: ex.batch]])
    ex.run_patch_batch(xs)
    _, busy, rows = device_profile(lambda: ex.run_patch_batch(xs), device,
                                   f"one batch of {xs.shape[0]} patches")
    # the batch launches conv3d once a direct layer; a trace that shows
    # fewer lost events, which the line says
    conv_us = sum(us for us, _, name in rows if "conv3d_" in name)
    conv_n = sum(n for _, n, name in rows if "conv3d_" in name)
    want_n = sum(pl.prim == "direct" for pl in ex.compiled.layers)
    print(f"profile: conv3d {conv_us / 1e3:.3f} ms in {conv_n} of the batch's {want_n} "
          f"launches, of {busy * 1e3:.3f} ms device time", flush=True)


def host_cpu_model() -> str:
    """The host CPU's model name, as ``lscpu`` and ``/proc/cpuinfo`` give it."""
    import shutil

    names = []
    if shutil.which("lscpu") is not None:
        out = subprocess.run(["lscpu"], capture_output=True, text=True)
        names += [f"lscpu: {line.split(':', 1)[1].strip()}"
                  for line in out.stdout.splitlines() if line.startswith("Model name:")]
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as fh:
            names += sorted({f"cpuinfo: {line.split(':', 1)[1].strip()}"
                             for line in fh if line.startswith("model name")})
    return "; ".join(names) or "not reported"


def run_split(smoke, device, net, params, vol, want, launches, serving):
    """Phase 4, split: the paper's CPU+GPU pipeline (``hetero``) and the
    two-stage pipeline (``pipeline2``), one volume swept offline each.
    Returns each split's output volume."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import planner
    from repro_torch.core.hw import H100_SXM, XEON_E7_8890V3_4WAY
    from repro_torch.volume import PlanExecutor

    print(f"hetero: the host stage is priced on the {XEON_E7_8890V3_4WAY.name} profile; "
          f"this host's CPU: {host_cpu_model()}, {os.cpu_count()} CPUs", flush=True)
    plans = {
        "hetero": planner.plan_hetero(net, (XEON_E7_8890V3_4WAY, H100_SXM), max_m=8),
        "pipeline2": planner.plan_pipeline2(net, H100_SXM, chips_per_stage=1, max_m=8),
    }
    outs = {}
    for label, plan in plans.items():
        if plan is None:
            smoke.check(False, f"{label}: the planner found no plan")
            continue
        print(f"{label} plan: devices {plan.devices}, theta {plan.theta}, m "
              f"{plan.m_final}, batch {plan.batch}, core {plan.core}, prims {plan.prims}, "
              f"predicted {plan.throughput:.1f} vox/s, stage_times {plan.stage_times}, "
              f"xfer_bytes {plan.xfer_bytes:.0f}", flush=True)
        ex = PlanExecutor(params, net, plan, tuned=None, device=device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
        kernels.reset_launch_counts()
        out = ex.run(vol)
        _sync(device)
        counts = kernels.launch_counts()
        s = ex.last_stats
        alloc = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        print(f"{label}: volume {vol.shape[1:]}, {s['patches']} patches, {s['batches']} "
              f"batches ({s['padded_patches']} padding), {s['seconds']:.3f} s = "
              f"{s['measured_voxps']:.1f} vox/s (predicted {s['predicted_voxps']:.1f}); "
              f"peak_device_bytes (ledger) {s['peak_device_bytes']:.0f}, "
              f"max_memory_allocated {alloc}; launches {json.dumps(counts)}", flush=True)
        outs[label] = out
        got = torch.from_numpy(out)
        ok, err = _close(got, want, **E2E)
        smoke.check(ok and bool(torch.isfinite(got).all()),
                    f"{label}: output {tuple(out.shape)} vs dense oracle: max_abs_err "
                    f"{err:.3e} (atol {E2E['atol']}, rtol {E2E['rtol']})")
        for name in REACHED[label]:
            smoke.check(counts[name] > 0, f"{label}: {name} launched {counts[name]} times")
        for name in launches:
            launches[name] += counts[name]
        row = dict(seconds=s["seconds"], voxps=s["measured_voxps"],
                   predicted_voxps=s["predicted_voxps"], ledger_peak=s["peak_device_bytes"],
                   max_memory_allocated=alloc)
        if label == "hetero":
            devs = [str(d) for d in ex.stage_devices]
            for k in (0, 1):
                print(f"hetero stage {k} ({plan.devices[k]} profile) ran on {devs[k]}: "
                      f"{s[f'stage{k}_seconds']:.3f} s, predicted "
                      f"{s[f'predicted_stage{k}_seconds']:.3f} s", flush=True)
            print(f"hetero hand-off: {s['xfer_bytes']:.0f} B in {s['xfer_seconds']:.3f} s "
                  f"({s['xfer_bytes'] / s['xfer_seconds'] / 1e9:.2f} GB/s through pinned "
                  f"host memory), predicted {s['predicted_xfer_bytes']:.0f} B in "
                  f"{s['predicted_xfer_seconds']:.3f} s", flush=True)
            smoke.check(s["xfer_bytes"] == s["predicted_xfer_bytes"],
                        f"hetero: xfer_bytes {s['xfer_bytes']:.0f} == predicted "
                        f"{s['predicted_xfer_bytes']:.0f}")
            smoke.check(devs[0] == str(device) and devs[1] == "cpu",
                        f"hetero: stage 0 on {devs[0]}, stage 1 on {devs[1]}")
            row.update({k: s[k] for k in (
                "stage0_seconds", "stage1_seconds", "xfer_seconds", "xfer_bytes",
                "predicted_stage0_seconds", "predicted_stage1_seconds",
                "predicted_xfer_seconds")}, stage_devices=devs)
        serving[label] = row
        del ex
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return outs


# the distributed phase's two ranks share the card: the gloo group's
# timeout, and the deadline for both ranks to exit
RANK_GROUP_TIMEOUT = 300  # seconds
RANK_JOIN_TIMEOUT = 600  # seconds
# what the ranks run: gathered_conv at the sub-layer phase's shapes
# (x (S, f, n³), w (f, f, k³)), halo_sharded on HALO_CX x-planes a rank of
# HALO_YZ² each, through a two-conv net of HALO_WIDTH maps
GATHERED = dict(S=128, f=80, n=35, k=3)
HALO_CX, HALO_YZ, HALO_WIDTH = 64, 128, 80


def run_distributed(smoke, device, net, params, vol, want, one_proc, one_proc_s,
                    launches):
    """Phase 4, distributed: two gloo ranks (``--rank`` processes of this
    script) on 127.0.0.1 share the card and run pipeline2 as a ring, then
    ``gathered_conv`` and ``halo_sharded_apply``.  Each rank zeroes the
    launch counts and the exchanged bytes just before each run and reads
    them just after; any rank's non-zero exit fails the phase."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.distributed.host_group import free_port

    with tempfile.TemporaryDirectory() as work:
        torch.save([None if p is None else (p[0].cpu(), p[1].cpu()) for p in params],
                    os.path.join(work, "params.pt"))
        np.save(os.path.join(work, "vol.npy"), vol)
        spec = dict(device=str(device), gathered=GATHERED,
                    halo=dict(cx=HALO_CX, yz=HALO_YZ, width=HALO_WIDTH),
                    net=dict(name=net.name, in_channels=net.in_channels,
                             layers=[[l.kind, l.size, l.out_channels] for l in net.layers]))
        with open(os.path.join(work, "spec.json"), "w") as fh:
            json.dump(spec, fh)
        port = free_port()
        logs = [open(os.path.join(work, f"rank{r}.log"), "w+") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world", "2",
             "--port", str(port), "--dir", work],
            stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
        t0 = time.perf_counter()
        try:
            # join both ranks by the deadline; a rank that fails ends the wait
            while any(p.poll() is None for p in procs):
                if (any(p.poll() not in (None, 0) for p in procs)
                        or time.perf_counter() - t0 > RANK_JOIN_TIMEOUT):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            for line in log.read().splitlines():
                print(f"rank {r}: {line}", flush=True)
            log.close()
            smoke.check(p.returncode == 0, f"distributed: rank {r} exited {p.returncode}")
        if any(p.returncode != 0 for p in procs):
            return {}
        res = []
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.json")) as fh:
                res.append(json.load(fh))
        outs = [np.load(os.path.join(work, f"pipeline2.{r}.npy")) for r in range(2)]
    print("distributed: two ranks share one card, so these times measure "
          "correctness and the cost of the hand-off through host memory, not scaling",
          flush=True)
    for r, (row, out) in enumerate(zip(res, outs)):
        p2 = row["pipeline2"]
        print(f"distributed pipeline2 rank {r}: {p2['patches']} patches in "
              f"{p2['batches']} chunks ({p2['padded_patches']} padding), {p2['seconds']:.3f} s "
              f"(one process: {one_proc_s:.3f} s), {p2['sent']} B sent and "
              f"{p2['received']} B received", flush=True)
        got = torch.from_numpy(out)
        ok, err = _close(got, want, **E2E)
        smoke.check(ok and bool(torch.isfinite(got).all()),
                    f"distributed pipeline2 rank {r}: output {tuple(out.shape)} vs dense "
                    f"oracle: max_abs_err {err:.3e} (atol {E2E['atol']}, rtol {E2E['rtol']})")
        if one_proc is not None:
            ok1, err1 = _close(got, torch.from_numpy(one_proc), **E2E)
            bitwise = bool(np.array_equal(out, one_proc))
            row["pipeline2"]["bitwise_one_process"] = bitwise
            smoke.check(ok1, f"distributed pipeline2 rank {r} vs the one-process "
                             f"pipeline2: max_abs_err {err1:.3e}, bitwise equal: {bitwise}")
        for label, reached in (("pipeline2", REACHED["pipeline2"]),
                               ("gathered_conv", REACHED["sublayer"]),
                               ("halo_sharded", ("conv3d",))):
            counts = row[label]["launches"]
            for name in reached:
                smoke.check(counts[name] > 0, f"distributed {label} rank {r}: {name} "
                                              f"launched {counts[name]} times")
            for name in launches:
                launches[name] += counts[name]
        for label in ("gathered_conv", "halo_sharded"):
            x = row[label]
            smoke.check(x["ok"], f"distributed {label} rank {r} vs its one-process "
                                 f"counterpart: max_abs_err {x['max_abs_err']:.3e} "
                                 f"(atol {E2E['atol']}, rtol {E2E['rtol']})")
        for name, x in row["collectives"].items():
            smoke.check(x["ok"], f"distributed {name} rank {r} vs its one-process math: "
                                 f"max_abs_err {x['max_abs_err']:.3e} ({x['tol']})")
    return {f"rank {r}": row for r, row in enumerate(res)}


def rank_main(rank: int, world: int, port: int, work: str) -> int:
    """One rank of the distributed phase (``chip_smoke.py --rank R --world
    N --port P --dir D``): pipeline2 of the split phase's plan on its
    volume as a ring, then ``gathered_conv`` at the sub-layer shapes, then
    ``halo_sharded_apply`` with ``direct`` prims on a pool-free two-conv
    net at n337's width; the net, device and sizes from ``D/spec.json``,
    results to ``D/rank{R}.json``."""
    sys.path.insert(0, SRC)
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.configs.base import ConvLayerSpec as L, ConvNetConfig as C
    from repro_torch.core import convnet, planner
    from repro_torch.core.distributed_inference import halo_sharded_apply
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.primitives import conv_apply
    from repro_torch.core.sublayer import gathered_conv
    from repro_torch.distributed import host_group
    from repro_torch.volume import PlanExecutor

    with open(os.path.join(work, "spec.json")) as fh:
        spec = json.load(fh)
    device = torch.device(spec["device"])
    net = C(spec["net"]["name"], spec["net"]["in_channels"],
            tuple(L(*l) for l in spec["net"]["layers"]))
    host_group.init_host_group(rank, world, port, timeout_s=RANK_GROUP_TIMEOUT)
    rows = {}

    def measured(label, fn):
        dist.barrier()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launch_counts()
        host_group.reset_exchanged_bytes()
        _sync(device)
        t = time.perf_counter()
        out = fn()
        _sync(device)
        row = dict(seconds=time.perf_counter() - t, launches=kernels.launch_counts(),
                   **host_group.exchanged_bytes(), max_memory_allocated=(
                       torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0))
        rows[label] = row
        return out, row

    def one_process(row, fn):
        _sync(device)
        t = time.perf_counter()
        out = fn()
        _sync(device)
        row["one_process_seconds"] = time.perf_counter() - t
        return out

    def close(row, got, want):
        ok, err = _close(got, want, **E2E)
        row.update(ok=ok, max_abs_err=err, shape=list(got.shape))

    try:
        params = [None if p is None else (p[0].to(device), p[1].to(device))
                  for p in torch.load(os.path.join(work, "params.pt"))]
        vol = np.load(os.path.join(work, "vol.npy"))
        plan = planner.plan_pipeline2(net, H100_SXM, chips_per_stage=1, max_m=8)
        ex = PlanExecutor(params, net, plan, tuned=None, device=device)
        out, row = measured("pipeline2", lambda: ex.run(vol))
        row.update({k: ex.last_stats[k] for k in (
            "patches", "batches", "padded_patches", "measured_voxps", "peak_device_bytes")})
        np.save(os.path.join(work, f"pipeline2.{rank}.npy"), out)
        del ex, params
        _free(device)

        gs = spec["gathered"]
        S, f, n, k = gs["S"], gs["f"], gs["n"], gs["k"]
        x = torch.randn((S, f, n, n, n), device=device,
                        generator=torch.Generator(device=device).manual_seed(11))
        g = torch.Generator().manual_seed(12)
        w = (torch.randn((f, f, k, k, k), generator=g) * (2.0 / (f * k**3)) ** 0.5).to(device)
        b = (0.1 * torch.randn((f,), generator=g)).to(device)
        sl = slice(rank * f // world, (rank + 1) * f // world)
        w_shard, b_shard = w[sl].contiguous(), b[sl].contiguous()
        got, row = measured("gathered_conv",
                            lambda: gathered_conv(x, w_shard, b_shard, variant="fft"))
        close(row, got, one_process(row, lambda: conv_apply("fft", x, w, b)))
        del x, got
        _free(device)

        # the reference test's pool-free two-conv net at n337's width
        hs = spec["halo"]
        cx, yz, width = hs["cx"], hs["yz"], hs["width"]
        hnet = C(f"halo-w{width}", 1, (L("conv", 3, width), L("conv", 2, width)))
        g = torch.Generator().manual_seed(13)
        hp = [(w_, 0.1 * torch.randn(w_.shape[:1], generator=g).to(device))
              for w_, _ in convnet.init_params(hnet, g, device=device)]
        nx = world * cx
        xh = torch.randn((1, 1, nx, yz, yz), generator=g).to(device)
        local = xh[:, :, rank * cx:(rank + 1) * cx].contiguous()
        prims = ["direct", "direct"]
        got, row = measured("halo_sharded",
                            lambda: halo_sharded_apply(hp, hnet, local, prims))
        want = one_process(row, lambda: convnet.apply_plan(hp, hnet, xh, prims))
        # valid: all but the last rank's FOV-1 = 3 trailing planes
        v = min(cx, nx - 3 - rank * cx)
        close(row, got[:, :, :v], want[:, :, rank * cx:rank * cx + v])
        for label, r in rows.items():
            extra = "".join(f", {k} {r[k]:.3e}" if k == "max_abs_err" else f", {k} {r[k]:.3f}"
                            for k in ("one_process_seconds", "max_abs_err") if k in r)
            print(f"{label}: {r['seconds']:.3f} s{extra}; sent {r['sent']} B, received "
                  f"{r['received']} B through pinned host memory; max_memory_allocated "
                  f"{r['max_memory_allocated']}; launches {json.dumps(r['launches'])}",
                  flush=True)
        dist.barrier()
        rows["collectives"] = rank_collectives(rank, world, device)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(rows, fh)
    return 0


def rank_collectives(rank: int, world: int, device):
    """The training collectives on card tensors in one rank, each against
    its one-process math: every rank draws every rank's inputs from one
    seed, so it knows what the others hold."""
    import torch

    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import host_group

    g = torch.Generator().manual_seed(14)
    K, N = 1024, 512
    x = torch.randn((64, K), generator=g).to(device)
    w = torch.randn((K, N), generator=g).to(device)
    shards = [torch.randn((8, 1024), generator=g).to(device) for _ in range(world)]
    grads = [torch.randn((4096,), generator=g).to(device) for _ in range(world)]

    def deq(v):  # the reference's int8 absmax round trip
        scale = torch.clamp(v.abs().max(), min=1e-12) / 127.0
        return torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8).float() * scale

    out = {}

    def record(name, got, want, exact=False, **tol):
        err = float((got - want).abs().max())
        ok = torch.equal(got, want) if exact else _close(got, want, **tol)[0]
        out[name] = dict(ok=bool(ok), max_abs_err=err, tol="bitwise" if exact else tol)

    host_group.reset_exchanged_bytes()
    t = time.perf_counter()
    k = K // world
    record("ring_allgather_matmul",
           coll.ring_allgather_matmul(x, w[rank * k:(rank + 1) * k].contiguous()), x @ w,
           atol=1e-3, rtol=1e-4)
    record("all_gather_chunked", coll.all_gather_chunked(shards[rank]), torch.cat(shards),
           exact=True)
    mean, err = coll.psum_compressed(grads[rank])
    want = deq(grads[0])
    for r in range(1, world):
        want = want + deq(grads[r])
    record("psum_compressed", mean, want / world, exact=True)
    record("psum_compressed error", err, grads[rank] - deq(grads[rank]), exact=True)
    e, acc = torch.zeros_like(grads[rank]), torch.zeros_like(grads[rank])
    for _ in range(30):  # error feedback: the running mean converges
        m, e = coll.psum_compressed(grads[rank], error=e)
        acc = acc + m
    record("psum_compressed 30 steps", acc / 30, sum(grads) / world, atol=1e-2, rtol=0.0)
    record("reduce_scatter_mean", coll.reduce_scatter_mean(shards[rank]),
           sum(shards).chunk(world)[rank] / world, atol=0.0, rtol=1e-6)
    _sync(device)
    secs = time.perf_counter() - t
    print(f"collectives: {secs:.3f} s, {json.dumps(host_group.exchanged_bytes())} B "
          f"through pinned host memory; " + "; ".join(
              f"{k_} ok {v['ok']} max_abs_err {v['max_abs_err']:.3e}" for k_, v in out.items()),
          flush=True)
    return out


def run_sublayers(smoke, device, plan, params, gen, launches, serving):
    """Phase 4, sub-layers: the f' and the S split at the first 80 -> 80
    ``fft_cached`` layer's shapes, operands in pinned host memory, against
    a one-shot ``conv_apply`` on the card."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.primitives import conv_apply
    from repro_torch.core.staging import pin
    from repro_torch.core.sublayer import streamed_conv_batch, streamed_conv_out_channels

    i = next(i for i, c in enumerate(plan.choices) if c.prim == "fft_cached")
    S, f, n = plan.choices[i].in_shape
    w, b = params[i]
    x_host = pin(torch.randn((S, f, *n), generator=gen), device)
    w_host, b_host = pin(w.cpu(), device), pin(b.cpu(), device)
    x_dev = x_host.to(device)

    def wall(fn, reps=2):
        fn()
        _sync(device)
        t = time.perf_counter()
        for _ in range(reps):
            r = fn()
        _sync(device)
        return r, (time.perf_counter() - t) * 1e3 / reps

    want, one_ms = wall(lambda: conv_apply("fft", x_dev, w, b))
    want = want.cpu()
    moved_in = _nb(x_host) + _nb(w_host) + _nb(b_host)
    print(f"sub-layers: layer {i} x {tuple(x_host.shape)} w {tuple(w.shape)}; one-shot "
          f"conv_apply('fft') on the card (operands there) {one_ms:.3f} ms", flush=True)
    row = dict(one_shot_ms=one_ms)
    for split, fn, chunk in (("out_channels", streamed_conv_out_channels, 16),
                             ("batch", streamed_conv_batch, max(1, S // 4))):
        kernels.reset_launch_counts()
        got, ms = wall(lambda: fn(x_host, w_host, b_host, chunk=chunk, variant="fft",
                                  device=device), reps=1)
        counts = kernels.launch_counts()
        moved = moved_in + _nb(got)
        ok, err = _close(got, want, **E2E)
        smoke.check(ok and got.device.type == "cpu",
                    f"sub-layer {split} (chunk {chunk}) vs one-shot conv: max_abs_err "
                    f"{err:.3e} (atol {E2E['atol']}, rtol {E2E['rtol']})")
        print(f"sub-layer {split} (chunk {chunk}): {ms:.3f} ms (one-shot {one_ms:.3f} ms), "
              f"{moved:.0f} B over the host link (computed from the shapes) = "
              f"{moved / ms / 1e6:.2f} GB/s; launches {json.dumps(counts)}", flush=True)
        for name in REACHED["sublayer"]:
            smoke.check(counts[name] > 0, f"sub-layer {split}: {name} launched "
                                          f"{counts[name]} times")
        for name in launches:
            launches[name] += counts[name]
        row[split] = dict(ms=ms, chunk=chunk, host_link_bytes=moved)
        del got
    serving["sublayers"] = row
    del x_host, x_dev, want
    if device.type == "cuda":
        torch.cuda.empty_cache()


def profile_tick(engine, vol, device):
    """One reuse-path serving tick under torch.profiler: the largest
    request once more, after one warm-up tick of its sweep; then drained."""
    from repro_torch.serving import VolumeRequest

    engine.submit(VolumeRequest(len(engine.finished) + 100, vol))
    engine.step()
    device_profile(engine.step, device,
                   f"one reuse-path tick (fuse_os {engine.executor.fuse_os}) of "
                   f"{engine.executor.batch} patches")
    engine.run_until_drained()


def device_profile(fn, device, label, top=20, timeline=False):
    """One call of ``fn`` under torch.profiler: device time by kernel, and
    the device's busy share of the call's wall time (one stream, so kernel
    times do not overlap); with ``timeline``, also every device event in
    launch order with its own time.  Returns (wall s, busy s, rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall = time.perf_counter() - t0

    def dev_us(e):
        for key in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, key, None)
            if v:
                return float(v)
        return 0.0

    # device-side events only (kernels, copies): the host-side ATen and
    # runtime rows carry their kernels' time too and would count it twice
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and dev_us(e) > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"profile: {label}, wall {wall * 1e3:.3f} ms, device busy "
          f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}% of wall)", flush=True)
    for us, count, name in rows[:top]:
        print(f"profile: {us / 1e3:10.3f} ms {count:6d}x  {name[:110]}", flush=True)
    if timeline:
        events = sorted((e for e in prof.events()
                         if str(getattr(e, "device_type", "")).endswith("CUDA")),
                        key=lambda e: e.time_range.start)
        for k, e in enumerate(events):
            print(f"timeline: {k:3d} {e.time_range.elapsed_us() / 1e3:10.3f} ms  "
                  f"{e.name[:110]}", flush=True)
    return wall, busy, rows


def plain_pool(smoke, device, net, hw, seed):
    """Phase 5: the plain-pool plan's subsampling sweep (P³ shifted passes
    a patch) through ``tiled_apply``, against the dense oracle."""
    import numpy as np
    import torch

    from repro_torch.core import convnet, planner
    from repro_torch.volume import tiled_apply

    prims = planner.plan_single(net, hw, use_mpf=False).prims
    gen = torch.Generator().manual_seed(seed + 2)
    params = convnet.init_params(net, gen, device=device)
    params = [None if p is None else (p[0], 0.1 * torch.randn(
        p[1].shape, generator=gen).to(device)) for p in params]
    fov, P = net.field_of_view(), net.total_pooling()
    vol = np.random.default_rng(seed + 2).normal(
        size=(net.in_channels, 2 * P + 3 + fov - 1, P + fov - 1, P + fov - 1)
    ).astype(np.float32)
    from repro_torch import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = tiled_apply(params, net, vol, prims, 1, batch=2, device=device)
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = convnet.apply_dense_reference(
        params, net, torch.from_numpy(vol)[None].to(device))[0].cpu()
    ok, err = _close(torch.from_numpy(out), want, **E2E)
    print(f"plain pool: {net.name} prims {prims}, P {P} ({P**3} shifted passes a "
          f"patch), {tuple(out.shape)} in {dt:.3f} s; launches {json.dumps(counts)}",
          flush=True)
    if device.type == "cuda":
        smoke.check(counts["conv3d"] > 0, f"plain pool: conv3d launched "
                                          f"{counts['conv3d']} times")
    smoke.check(ok, f"plain-pool tiled_apply vs dense oracle: max_abs_err {err:.3e} "
                    f"(atol {E2E['atol']}, rtol {E2E['rtol']}, "
                    f"max|ref| {float(want.abs().max()):.3f})")


# ---------------------------------------------------------------------------
# Phase 6: the other three Table III nets

# (net, first fragment size m to try, batch): the deployed reuse mix on an
# H100 plan; m drops by half while plan_fixed finds the point infeasible.
# The volume is two cores along x, so the second patch walks the strip
# path; batch 1 keeps the 80 -> 80 kernel spectra (up to ~23 GB a layer
# at these FOVs) and the patch's activations within the card.
ZNNI_SERVED = (("n537", 4, 1), ("n726", 8, 1), ("n926", 8, 1))


def _plan_line(label, plan) -> str:
    if plan is None:
        return f"{label}: infeasible"
    return (f"{label}: m {plan.m_final} batch {plan.batch} core {plan.core} n_in "
            f"{plan.n_in} predicted {plan.throughput:.1f} vox/s, peak "
            f"{plan.peak_bytes:.0f} B, device {plan.memory.device_bytes:.0f} B; prims "
            f"{plan.prims}")


def serve_znni_net(smoke, device, net, m, batch, hw, gen, seed):
    """One Table III net at full width (80 maps, every layer, random
    weights from the seed) on the deployed reuse mix: its kernels against
    their plain versions at the compiled plan's shapes, then one volume of
    two cores along x served with ``fuse_os`` and held against the dense
    oracle.  Returns the serve's stats and launch counts."""
    import numpy as np
    import torch

    from repro_torch.core import convnet, planner
    from repro_torch.serving import VolumeEngine

    params = convnet.init_params(net, gen, device=device)
    params = [None if p is None else (p[0], 0.1 * torch.randn(
        p[1].shape, generator=gen).to(device)) for p in params]
    prims = ["overlap_save" if i == 0 else ("fft_cached" if l.kind == "conv" else "mpf")
             for i, l in enumerate(net.layers)]
    fov, P = net.field_of_view(), net.total_pooling()
    plan = None
    while plan is None and m >= 1:
        core = m * P
        shape = (2 * core + fov - 1, core + fov - 1, core + fov - 1)
        points = []
        plan = planner.plan_fixed(net, hw, prims, m=m, batch=batch, volume_shape=shape,
                                  infeasible=points)
        if plan is None:
            print(f"{net.name}: plan_fixed infeasible at m {m} batch {batch}: "
                  + "; ".join(str(pt) for pt in points), flush=True)
            m //= 2
    smoke.check(plan is not None, f"{net.name}: a feasible served plan on {hw.name}")
    if plan is None:
        return {}, {}
    print(_plan_line(f"{net.name} served plan (fov {fov}, P {P}, volume {shape})", plan),
          flush=True)
    print(_plan_line(f"{net.name} plan_single on {hw.name}", planner.plan_single(net, hw)),
          flush=True)
    vol = np.random.default_rng(seed).normal(size=(net.in_channels,) + shape).astype(
        np.float32)
    t = time.perf_counter()
    want = dense_oracle(net, params, vol, device)
    _sync(device)
    print(f"{net.name}: dense oracle {tuple(want.shape)} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    _free(device)
    engine = VolumeEngine(params, net, plan, fuse_os=True, tuned=None, device=device)
    check_kernels(smoke, engine.executor, plan, device, gen, timed=False)
    _free(device)
    engine, counts, stats = serve(smoke, f"{net.name} fuse_os", REACHED[True], net, plan,
                                  params, [vol], [want], device, engine=engine,
                                  need_mixed=False)
    stats.update(m=plan.m_final, batch=plan.batch, core=plan.core, n_in=plan.n_in,
                 predicted_voxps=plan.throughput)
    del engine
    _free(device)
    return stats, counts


def run_znni_nets(device, hw, seed=0):
    """Phase 6: n537, n726 and n926 served on the card, then the paper's
    headline question priced on (Xeon, this card).  Returns (serving
    stats, launch counts, failures)."""
    import torch

    from repro_torch.configs.znni_nets import ZNNI_NETS
    from repro_torch.core import planner
    from repro_torch.core.hw import XEON_E7_8890V3_4WAY

    smoke = Smoke()
    gen = torch.Generator().manual_seed(seed + 5)
    serving, launches = {}, {name: 0 for name in KERNELS}
    for name, m, batch in ZNNI_SERVED:
        t = time.perf_counter()
        serving[name], counts = serve_znni_net(smoke, device, ZNNI_NETS[name], m, batch, hw,
                                               gen, seed + 5)
        for k, v in counts.items():
            launches[k] += v
        print(f"{name} phase: {time.perf_counter() - t:.1f} s", flush=True)
    # the paper's headline question asked of the card, priced only: the
    # host-CPU profile is the paper's Xeon, uncalibrated for this machine
    net = ZNNI_NETS["n726"]
    devices = (XEON_E7_8890V3_4WAY, hw)
    budgets = tuple(float(d.hbm_bytes) for d in devices)
    hetero = planner.plan_hetero(net, devices, chips_per_stage=1, max_m=40,
                                 ram_budgets=budgets)
    singles = [planner.plan_single(net, d, max_m=40, ram_budget=b)
               for d, b in zip(devices, budgets)]
    if hetero is not None:
        print(f"hetero n726 on ({devices[0].name}, {devices[1].name}): devices "
              f"{hetero.devices} theta {hetero.theta} m {hetero.m_final} batch "
              f"{hetero.batch} stage_times {hetero.stage_times} xfer {hetero.xfer_bytes:.0f} "
              f"B / {hetero.xfer_seconds:.6f} s, predicted {hetero.throughput:.1f} vox/s; "
              f"prims {hetero.prims}", flush=True)
    for d, plan in zip(devices, singles):
        print(_plan_line(f"n726 plan_single on {d.name}", plan), flush=True)
    smoke.check(hetero is not None and all(p is not None for p in singles),
                "n726: plan_hetero and both plan_singles priced")
    if hetero is not None and all(p is not None for p in singles):
        best = max(singles, key=lambda p: p.throughput)
        print(f"hetero n726: predicted {hetero.throughput:.1f} vox/s against the best "
              f"single device's {best.throughput:.1f} ({hetero.throughput / best.throughput:.3f}x)"
              f" (priced only)", flush=True)
        serving["hetero_n726_priced"] = dict(
            hetero_voxps=hetero.throughput, theta=hetero.theta, devices=list(hetero.devices),
            single_voxps={d.name: p.throughput for d, p in zip(devices, singles)})
    return serving, launches, smoke.failures


# Served Qwen2.5-14B (bf16): a served token's logit may sit below its row's
# maximum in a plain forward by this much, and one decode step with the
# kernel may move a logit from the plain version's by this much.  The two
# paths round differently (M=8 GEMMs and the decode kernel one token at a
# time against M=P+n GEMMs and chunked attention), and 48 random bf16
# layers amplify a one-ulp difference: a decode_attn output one bf16 ulp
# off (2e-3) moved logits by up to 0.41 (this script on an NVIDIA H100
# 80GB HBM3 at 700 W), and the worst served-token gap was 0.34, against
# row maxima ~5 sigma above the row mean.  A broken path puts the served
# token at a random rank, about that far below the maximum.
LOGIT_TOL = 1.0
# The MoE archs' router logits: the plain forward's, routed as the served
# decode routed, against the served decode's, at every MoE layer and
# position.  Between the largest sound reading and the smallest wrong one
# (this script on an NVIDIA H100 80GB HBM3 at 700 W): bf16 reads 0.21
# (mixtral, 24 layers), 0.12 (grok, 5) and 0.81 (jamba, 8; 0.0017 in f32),
# while the forward fed a wrong router input reads 2.40 or more (its own
# routing, parted from the served upstream: 2.40 / 2.65 / 2.88; the next
# MoE layer's or the previous position's served logits: 3.82 and more,
# checked every run).  The router logits are N(0, ~2).
ROUTER_TOL = 1.0
# decode_attn tolerances: the reference's (tests/test_kernels.py)
DA_TOL = {"bfloat16": dict(atol=2e-2, rtol=1e-2), "float32": dict(atol=1e-4, rtol=1e-4)}


class Routes:
    """The MoE router's choices, through ``layers.moe.route``.  Inside
    ``hooked()`` each call's router logits and expert ids are recorded
    under the current ``tag``; with ``force`` (an iterator of expert-id
    tensors, one a call) each call routes to the given ids instead, its
    weights renormalised from the call's own probabilities, and records
    the ids it would have chosen."""

    def __init__(self, force=None):
        self.calls = []  # (tag, router logits (G, T, E) f32, own ids (G, T, K))
        self.tag = None
        self.force = None if force is None else iter(force)

    @contextlib.contextmanager
    def hooked(self):
        from repro_torch.layers import moe as moe_l

        own_route = moe_l.route

        def route(p, xt, cfg):
            probs, topw, topi = own_route(p, xt, cfg)
            self.calls.append((self.tag, xt.float() @ p["router"], topi))
            if self.force is not None:
                topi = next(self.force)
                topw = probs.gather(-1, topi)
                topw = topw / topw.sum(dim=-1, keepdim=True)
            return probs, topw, topi

        moe_l.route = route
        try:
            yield self
        finally:
            moe_l.route = own_route

    def by_request(self, n_moe: int):
        """{rid: [per MoE layer: {position: (router logits (E,), ids (K,))}]}
        from a drain's tagged calls: a prefill's rows are its prompt's
        positions, a decode tick's rows its slots'."""
        out = {}
        for i in range(0, len(self.calls), n_moe):
            group = self.calls[i:i + n_moe]
            kind, info = group[0][0]
            rows = ([(info, pos, pos) for pos in range(group[0][1].shape[1])]
                    if kind == "prefill" else
                    [(who[0], who[1], slot) for slot, who in enumerate(info) if who])
            for rid, pos, row in rows:
                layers = out.setdefault(rid, [dict() for _ in range(n_moe)])
                for m, (_, logits, ids) in enumerate(group):
                    layers[m][pos] = (logits[0, row], ids[0, row])
        return out


def _layer_blocks(cfg):
    """(mixer, is_moe) of each layer, in order."""
    from repro_torch.configs.base import parse_block_token

    PL = len(cfg.block_pattern)
    toks = list(cfg.block_pattern) * (cfg.n_layers // PL) + list(
        cfg.block_pattern[: cfg.n_layers % PL])
    return [parse_block_token(t) for t in toks]


def moe_layers(cfg) -> int:
    return sum(is_moe for _, is_moe in _layer_blocks(cfg)) if cfg.d_ff > 0 else 0


def global_attention_layers(cfg) -> int:
    """Layers whose decode goes through ``decode_attn``: full attention."""
    return sum(mixer in ("attn", "global") for mixer, _ in _layer_blocks(cfg))


def _tag_routes(engine, routes):
    """Tag the engine's model calls for ``routes``: a prefill with its
    request, a decode tick with each slot's (request, fed position)."""
    prefill_into = engine._prefill_into_slot
    decode = engine.model.decode_step

    def tagged_prefill(slot, req):
        routes.tag = ("prefill", req.rid)
        prefill_into(slot, req)

    def tagged_decode(params, tokens, caches, **kw):
        routes.tag = ("decode", [None if r is None else (r.rid, len(r.prompt) + len(r.out) - 1)
                                 for r in engine.slot_req])
        return decode(params, tokens, caches, **kw)

    engine._prefill_into_slot = tagged_prefill
    engine.model = dataclasses.replace(engine.model, decode_step=tagged_decode)


def check_decode_attn(smoke, device, gen, cases, timed=True):
    """Phase 8a: ``decode_attn`` vs its plain version; with ``timed`` the
    first case (the served shapes) is timed beside its bound and PyTorch's
    SDPA, and its result returned.  A case may end with its lengths;
    otherwise they are drawn, the first S + 5."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import ops as da_ops

    result = None
    for label, B, S, Hkv, G, d, dt, *given in cases:
        dtype = getattr(torch, dt)
        H = Hkv * G
        q = torch.randn((B, H, d), generator=gen).to(device, dtype)
        k = torch.randn((B, S, Hkv, d), generator=gen).to(device, dtype)
        v = torch.randn((B, S, Hkv, d), generator=gen).to(device, dtype)
        if given:
            lengths = torch.tensor(given[0], dtype=torch.int32)
        else:
            lengths = torch.randint(1, S + 1, (B,), generator=gen, dtype=torch.int32)
            lengths[0] = S + 5  # a slot past its cache, as idle slots run
        lengths = lengths.to(device)
        got = da_ops.decode_attn(q, k, v, lengths)
        want = da_ops.decode_attn(q, k, v, lengths, use_kernels=False)
        tol = DA_TOL[dt]
        ok, err = _close(got.float(), want.float(), **tol)
        smoke.check(ok and got.dtype == dtype,
                    f"decode_attn ({label}) vs plain, B {B} S {S} Hkv {Hkv} G {G} d {d} "
                    f"{dt}, lengths {lengths.tolist()}: max_abs_err {err:.3e} "
                    f"(atol {tol['atol']}, rtol {tol['rtol']})")
        if result is not None or not timed:
            continue
        # the function's compulsory traffic: q, the valid K/V rows, the
        # lengths and the output, each once; 4 operations per (head,
        # valid row, d) for the scores and the PV product
        valid = float(torch.clamp(lengths, max=S).sum())
        nbytes = (_nb(q) + 2.0 * valid * Hkv * d * q.element_size() + _nb(lengths)
                  + _nb(got))
        flops = 4.0 * valid * H * d
        r = dict(max_abs_err=err)
        r["bound_ms"], r["bound_by"] = bound(
            nbytes, flops, PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32)
        r["ms"] = time_ms(lambda: da_ops.decode_attn(q, k, v, lengths), device, reps=50,
                          warmup=3)
        r["plain_ms"] = time_ms(
            lambda: da_ops.decode_attn(q, k, v, lengths, use_kernels=False), device, reps=10)
        qs, ks, vs = q.view(B, H, 1, d), k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(S, device=device)[None] < lengths[:, None])[:, None, None]
        r["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True), device, reps=50, warmup=3)
        lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
        print(f"kernel decode_attn ({label}): {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"SDPA {r['library_ms']:.4f} ms (its max_abs_err vs plain "
              f"{float((lib.view(B, H, d).float() - want.float()).abs().max()):.3e}), "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}): {nbytes / 1e6:.3f} MB, "
              f"{valid:.0f} valid rows", flush=True)
        result = r
    return result


def serve_lm(smoke, device, cfg, *, slots, max_seq, n_requests, prompt_range,
             new_range, seed=0):
    """Phase 8b: serve ``cfg`` through ``ServingEngine``; returns the
    model, params, engine, requests, the launch counts and stats of the
    drain, and for the MoE archs the served routing
    (``Routes.by_request``; else None)."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, Request, ServingEngine

    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    t = time.perf_counter()
    params = model.init(gen, device=device)
    _sync(device)
    n_params = sum(p.numel() for p in _leaves(params))
    heads = ("no attention" if cfg.attn is None else
             f"{cfg.attn.n_heads} heads on {cfg.attn.n_kv_heads} kv heads")
    print(f"lm: {cfg.name}, {cfg.n_layers} layers {cfg.block_pattern}, d_model "
          f"{cfg.d_model}, {heads}, d_ff {cfg.d_ff}, moe {cfg.moe}, ssm {cfg.ssm}, "
          f"vocab {cfg.vocab}, {cfg.dtype}: {n_params} parameters drawn in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    engine = ServingEngine(model, params, EngineConfig(slots=slots, max_seq=max_seq),
                           device=device)
    rng = np.random.default_rng(seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab, size=(int(rng.integers(*prompt_range)),))
                    .astype(np.int32), int(rng.integers(*new_range)))
            for i in range(n_requests)]
    for r in reqs:
        engine.submit(r)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # the MoE archs' routing, recorded call by call for check_lm
    routes = Routes() if moe_layers(cfg) else None
    if routes is not None:
        _tag_routes(engine, routes)
    _sync(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ticks, admitted_late = 0, False
    with routes.hooked() if routes is not None else contextlib.nullcontext():
        while True:
            queued = len(engine.queue)
            if engine.step() == 0:
                break
            ticks += 1
            admitted_late |= ticks > 1 and len(engine.queue) < queued
    _sync(device)
    dt = time.perf_counter() - t0
    if routes is not None:
        del engine._prefill_into_slot
        engine.model = model
        routes = routes.by_request(moe_layers(cfg))
    counts = kernels.launch_counts()
    generated = sum(len(r.out) for r in reqs)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"serve lm: {n_requests} requests ({prompt_tokens} prompt tokens, lengths "
          f"{[len(r.prompt) for r in reqs]}, max_new {[r.max_new for r in reqs]}) on "
          f"{slots} slots: {generated} generated tokens, {ticks} decode ticks in {dt:.3f} s "
          f"= {generated / dt:.1f} generated tokens/s; max_memory_allocated {peak}; "
          f"launches {json.dumps(counts)}", flush=True)
    smoke.check(all(r.done and len(r.out) == r.max_new for r in reqs),
                "lm: every request done with max_new tokens")
    smoke.check(not engine.queue and admitted_late,
                "lm: requests admitted mid-run (more requests than slots)")
    # decode_attn serves the global-attention layers; windowed (local)
    # decode is plain PyTorch, as the reference's is plain XLA
    n_global = global_attention_layers(cfg)
    want = n_global * ticks
    smoke.check(counts["decode_attn"] == want and ticks > 0,
                f"lm {cfg.name}: decode_attn launched {counts['decode_attn']} times == "
                f"{n_global} global-attention layers x {ticks} decode ticks")
    if n_global:
        for name in REACHED["lm"]:
            smoke.check(counts[name] > 0, f"lm {cfg.name}: {name} launched "
                                          f"{counts[name]} times on the main path")
    stats = dict(seconds=dt, generated=generated, ticks=ticks, tokens_per_s=generated / dt,
                 max_memory_allocated=peak)
    return model, params, engine, reqs, counts, stats, routes


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif v is not None:  # "blocks" of a model shallower than its pattern
            yield v


def _gaps(logits, r):
    """A request's served tokens against ``logits`` of its prompt plus
    generated tokens: (gap of each served token to its row's maximum,
    the rows)."""
    import torch

    rows = logits[0, len(r.prompt) - 1:].float()
    served = torch.as_tensor(r.out, device=rows.device)
    return rows.max(dim=-1).values - rows.gather(1, served[:, None])[:, 0], rows


def _same_experts(a, b):
    """Positions whose expert sets agree, for ids (..., K) in any order."""
    return (a.sort(dim=-1).values == b.sort(dim=-1).values).all(dim=-1)


def check_lm(smoke, device, model, params, engine, reqs, routes=None):
    """Phase 8c: served tokens against a plain forward; one decode step
    with the kernel against one with the plain version, on a fixed cache.

    With MoE blocks a router near-tie that bf16 rounding tips the other
    way between two paths sends a token to another expert and moves its
    output whole, so the MoE archs are held against the plain forward
    routed as the served decode routed (``routes``: the same expert ids,
    the weights from the forward's own probabilities), and the
    forward's own router logits against the served ones, both within
    ``LOGIT_TOL``; the forward with its own routing is printed beside them
    with the places its routing differs.  The fixed-cache decode step's
    plain run routes as its kernel run."""
    import torch

    from repro_torch.layers.dot import f32_accumulation

    cfg = model.cfg
    n_moe = moe_layers(cfg)
    worst, own_worst, exact, total, sigma, spread = 0.0, 0.0, 0, 0, 0.0, 0.0
    flips, places, router_err, margin = 0, 0, 0.0, 0.0
    wrong_layer, wrong_pos = math.inf, math.inf
    with f32_accumulation():
        for r in reqs:
            seq = list(r.prompt) + r.out[:-1]
            toks = torch.as_tensor(seq, dtype=torch.long, device=device)[None]
            logits, _ = model.forward(params, {"tokens": toks})
            gap, rows = _gaps(logits, r)
            if n_moe:
                own_worst = max(own_worst, float(gap.max()))
                del logits
                served = routes[r.rid]
                T = len(seq)
                forced = [torch.stack([served[m][pos][1] for pos in range(T)])[None]
                          for m in range(n_moe)]
                tape = Routes(force=forced)
                with tape.hooked():
                    logits, _ = model.forward(params, {"tokens": toks})
                gap, rows = _gaps(logits, r)
                # along the served routing, the forward's router logits, and
                # the places where they would pick other experts
                lgs, slgs = [], []
                for m, (_, lg, ids) in enumerate(tape.calls):
                    slg = torch.stack([served[m][pos][0] for pos in range(T)])[None]
                    router_err = max(router_err, float((lg - slg).abs().max()))
                    lgs.append(lg)
                    slgs.append(slg)
                    other = ~_same_experts(ids, forced[m])
                    flips += int(other.sum())
                    places += T
                    if bool(other.any()):
                        # the forward's own logit margin between the experts
                        # it would pick and the served ones it would not
                        mine = lg.gather(-1, ids).min(dim=-1).values
                        theirs = lg.gather(-1, forced[m]).min(dim=-1).values
                        margin = max(margin, float((mine - theirs)[other].max()))
                # the same comparison fed a wrong router input, as a fault
                # would: the next MoE layer's served logits, or the served
                # logits one position earlier
                for m in range(n_moe):
                    if m + 1 < n_moe:
                        wrong_layer = min(wrong_layer,
                                          float((lgs[m] - slgs[m + 1]).abs().max()))
                    if T > 1:
                        wrong_pos = min(wrong_pos, float(
                            (lgs[m][:, 1:] - slgs[m][:, :-1]).abs().max()))
                del lgs, slgs
            worst = max(worst, float(gap.max()))
            exact += int((gap == 0).sum())
            total += len(r.out)
            sigma += float(rows.std(dim=-1).sum())
            spread += float((rows.max(dim=-1).values - rows.mean(dim=-1)).sum())
            del logits, rows
    routed = " routed as the served decode routed" if n_moe else ""
    smoke.check(worst <= LOGIT_TOL,
                f"lm {cfg.name}: every served token's logit within {LOGIT_TOL} of its row's "
                f"maximum in a plain forward{routed}: worst gap {worst:.4f}; {exact} of "
                f"{total} served tokens are the forward's argmax; rows: mean std "
                f"{sigma / total:.3f}, mean (max - mean) {spread / total:.3f}")
    if n_moe:
        smoke.check(router_err <= ROUTER_TOL,
                    f"lm {cfg.name}: along the served routing, the plain forward's router "
                    f"logits within {ROUTER_TOL} of the served decode's at every MoE layer "
                    f"and position: max_abs_err {router_err:.4f}")
        smoke.check(min(wrong_layer, wrong_pos) > ROUTER_TOL,
                    f"lm {cfg.name}: the router gate fails a wrong router input: fed the "
                    f"next MoE layer's served logits it reads {wrong_layer:.4f}, fed the "
                    f"previous position's {wrong_pos:.4f} (each the least over requests and "
                    f"MoE layers of the largest |error|), both above {ROUTER_TOL}")
        print(f"lm {cfg.name}: along the served routing the plain forward's own router "
              f"would pick other experts at {flips} of {places} (MoE layer, position) "
              f"places, by a logit margin of at most {margin:.4f}; the plain forward "
              f"routing itself: worst served-token gap {own_worst:.4f} (not gated: a "
              f"routing flip moves a token's output whole)", flush=True)

    caches = engine.caches

    def fixed():
        return {"blocks": {j: {k: t.clone() for k, t in c.items()}
                           for j, c in caches["blocks"].items()},
                "rem": {j: {k: t.clone() for k, t in c.items()}
                        for j, c in caches["rem"].items()},
                "lengths": caches["lengths"].clone()}

    tokens = engine._next_tok.clone()
    with f32_accumulation():
        kernel_routes = Routes()
        with kernel_routes.hooked():
            got, _ = model.decode_step(params, tokens, fixed(),
                                       use_kernels=device.type == "cuda")
        plain_routes = Routes(force=[ids for _, _, ids in kernel_routes.calls])
        with plain_routes.hooked():
            want, _ = model.decode_step(params, tokens, fixed(), use_kernels=False)
    err = float((got.float() - want.float()).abs().max())
    same = int((got[:, 0].argmax(-1) == want[:, 0].argmax(-1)).sum())
    step_flips = sum(int((~_same_experts(a[2], b[2])).sum())
                     for a, b in zip(kernel_routes.calls, plain_routes.calls))
    smoke.check(err <= LOGIT_TOL,
                f"lm {cfg.name}: decode_step logits with the kernel vs the plain version on a "
                f"fixed cache (lengths {caches['lengths'].tolist()}{routed.replace('served decode', 'kernel run')}): "
                f"max_abs_err {err:.4f} (atol {LOGIT_TOL}); argmax equal in {same} of "
                f"{got.shape[0]} slots; the plain run's own routing differs at {step_flips} "
                f"places")
    out = dict(worst_gap=worst, exact=exact, total=total, decode_step_err=err,
               logit_std=sigma / total, logit_top_minus_mean=spread / total)
    if n_moe:
        out.update(own_routing_worst_gap=own_worst, routing_flips=flips, routing_places=places,
                   router_logit_err=router_err, flip_margin=margin,
                   wrong_layer_err=wrong_layer, wrong_position_err=wrong_pos,
                   decode_step_flips=step_flips)
    return out


def time_tick(tick, device, label):
    """One warm-up call of the decode tick ``tick``, five on the host clock,
    then one under torch.profiler: (host ms a tick, profiled wall s, device
    busy s, ``decode_attn``'s device ms)."""
    tick()
    _sync(device)
    t = time.perf_counter()
    for _ in range(5):
        tick()
    _sync(device)
    tick_ms = (time.perf_counter() - t) * 1e3 / 5
    wall, busy, rows = device_profile(tick, device, label, top=12)
    return tick_ms, wall, busy, sum(us for us, _, name in rows if "decode_attn" in name) / 1e3


def time_lm(smoke, device, model, params, engine, reqs, stats, routes, *, slots, max_seq):
    """Decode ticks on the drained engine's caches (each writes the same
    rows: the engine's lengths are not advanced), timed on the host clock;
    then one under torch.profiler; then the longest prompt's prefill; then
    ``check_lm``.  Updates and prints ``stats``."""
    import torch

    from repro_torch.layers.dot import f32_accumulation

    cfg = model.cfg

    def tick():
        return model.decode_step(params, engine._next_tok, engine.caches)

    longest = max(reqs, key=lambda r: len(r.prompt)).prompt
    toks = torch.as_tensor(longest, dtype=torch.long, device=device)[None]
    with f32_accumulation():
        tick_ms, wall, busy, da_ms = time_tick(tick, device,
                                               f"one decode tick of {cfg.name}, {slots} slots")
        t = time.perf_counter()
        model.prefill(params, {"tokens": toks}, cache_len=max_seq)
        _sync(device)
        prefill_ms = (time.perf_counter() - t) * 1e3
    print(f"lm {cfg.name}: decode tick {tick_ms:.3f} ms on the host clock (5 ticks, no "
          f"profiler) = {slots / tick_ms * 1e3:.1f} tokens/s at {slots} busy slots, "
          f"{busy * 1e3:.3f} ms of device time under the profiler; prefill of "
          f"{len(longest)} tokens {prefill_ms:.3f} ms", flush=True)
    print(f"profile: decode_attn {da_ms:.3f} ms of the tick's {busy * 1e3:.3f} ms "
          f"device time", flush=True)
    stats.update(tick_ms=tick_ms, tick_profiled_wall_ms=wall * 1e3,
                 tick_busy_ms=busy * 1e3, tick_decode_attn_ms=da_ms,
                 prefill_ms=prefill_ms, prefill_tokens=len(longest))
    stats.update(check_lm(smoke, device, model, params, engine, reqs, routes))
    print(f"serving lm {cfg.name}: " + json.dumps(stats), flush=True)
    return stats


def run_lm(device, cfg, *, da_cases, slots, max_seq, n_requests, prompt_range, new_range,
           seed=0):
    """Phase 8: the LM serving path; returns (decode_attn result, failures)."""
    import torch

    smoke = Smoke()
    gen = torch.Generator().manual_seed(seed + 3)
    result = check_decode_attn(smoke, device, gen, da_cases)
    model, params, engine, reqs, counts, stats, routes = serve_lm(
        smoke, device, cfg, slots=slots, max_seq=max_seq, n_requests=n_requests,
        prompt_range=prompt_range, new_range=new_range, seed=seed)
    result["launches"] = counts["decode_attn"]
    time_lm(smoke, device, model, params, engine, reqs, stats, routes, slots=slots,
            max_seq=max_seq)
    return result, smoke.failures


# The archs of the MoE, Mamba2 and local/global blocks, served at full
# width with bf16 weights drawn on the card: (arch, layers), None for the
# most layers that fit on the card (``fit_depth``; full depth where it
# holds them all).  Jamba keeps one 8-layer pattern: at the 21 that fit,
# its bf16 served decode parts from the plain forward by more than
# LOGIT_TOL (ROADMAP Queue 3), so it is gated at 8 and its fitted depth
# is read by ``LM_PROBE``.
LM_ARCHS = (("mamba2-2.7b", None), ("phi3-medium-14b", None), ("gemma3-27b", None),
            ("mixtral-8x7b", None), ("grok-1-314b", None), ("jamba-v0.1-52b", 8))
# a smaller grid than Qwen2.5-14B's: more requests than slots, so some
# are admitted mid-run
LM_ARCH_GRID = dict(slots=4, max_seq=512, n_requests=6, prompt_range=(16, 257),
                    new_range=(8, 21))
# served again in f32 at the same depth: the served decode's distance from
# the forward must close there (bf16 rounding, not the port): jamba's
# router logits (0.81 at 8 layers, against ~0.1 for mixtral and grok) and
# Mamba2's served-token gaps (0.61 at 64 layers, the largest of the
# non-MoE archs)
LM_F32_WITNESS = ("mamba2-2.7b", "jamba-v0.1-52b")
# served at the most layers that fit, the checks printed and not gated
LM_PROBE = ("jamba-v0.1-52b",)
# memory kept free beside an arch's weights and caches when its depth is
# fitted: the CUDA context, the checks' activations (plain forwards of up
# to 276 tokens with f32 logits, the drop-free expert buffers) and the
# allocator's slack
LM_RESERVE = 8 << 30


def fit_depth(cfg, slots: int, max_seq: int, total: int):
    """The most layers of ``cfg`` (up to its own) that fit in ``total``
    bytes: the weights, plus the larger of what drawing them holds beside
    them (one layer, and the largest tensor's f32 draw where the weights
    are narrower; ``init_params``) and the caches, plus ``LM_RESERVE``.
    Returns (layers, {"weights", "transient", "caches", "need", and
    "next_need" of one layer more} in bytes)."""
    import torch

    from repro_torch.models.transformer import _cache_shape_for

    def size(dt):
        return torch.empty((), dtype=getattr(torch, dt) if isinstance(dt, str) else dt
                           ).element_size()

    el = size(cfg.dtype)
    weights = [el * dataclasses.replace(cfg, n_layers=n).param_count()
               for n in range(cfg.n_layers + 1)]
    d, moe = cfg.d_model, cfg.moe
    leaf = max(cfg.vocab * d, d * cfg.d_ff * (moe.n_experts if moe else 1),
               d * cfg.ssm.d_inner(d) if cfg.ssm else 0,
               d * cfg.attn.n_heads * cfg.attn.head_dim if cfg.attn else 0)
    transient = (max(b - a for a, b in zip(weights, weights[1:]))
                 + (4 * leaf if el < 4 else 0))
    caches = [0]
    for n in range(cfg.n_layers):
        tok = cfg.block_pattern[n % len(cfg.block_pattern)]
        caches.append(caches[-1] + sum(math.prod(shape) * size(dt) for shape, dt in
                                       _cache_shape_for(cfg, tok, slots, max_seq).values()))
    need = [w + max(transient, c) + LM_RESERVE for w, c in zip(weights, caches)]
    n = max([k for k in range(1, cfg.n_layers + 1) if need[k] <= total], default=0)
    return n, dict(weights=weights[n], transient=transient, caches=caches[n], need=need[n],
                   next_need=need[n + 1] if n < cfg.n_layers else None)


def lm_arch_config(name: str, total: int, *, slots: int, max_seq: int, depth=None,
                   dtype=None):
    """The arch's config in ``dtype`` (None: its own) at ``depth`` layers
    (None: the most that fit in ``total`` bytes, ``fit_depth``), with the
    MoE capacity factor raised to the expert count: served decode routes
    the slots' tokens together and ``forward`` a whole sequence, so with
    capacity drops the two would drop different tokens by design;
    drop-free they compute the same function (the reference's own
    decode-vs-forward test raises it the same way,
    ``tests/test_models_smoke.py``).  Returns (config, the cuts as text)."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    cuts = []
    if dtype is not None and dtype != cfg.dtype:
        cuts.append(f"dtype {cfg.dtype} -> {dtype}")
        cfg = dataclasses.replace(cfg, dtype=dtype)
    fit, mem = fit_depth(cfg, slots, max_seq, total)
    if fit == 0:
        raise RuntimeError(f"{name}: not one layer fits in {total / 1e9:.1f} GB")
    layers = min(fit, cfg.n_layers if depth is None else depth)
    if layers < cfg.n_layers:
        full = 2 * get_config(name).param_count() / 1e9
        if layers == fit:
            cuts.append(
                f"depth {layers} of {cfg.n_layers} layers, the most that fit: weights "
                f"{mem['weights'] / 1e9:.1f} GB + max(init transient "
                f"{mem['transient'] / 1e9:.1f} GB, caches {mem['caches'] / 1e9:.2f} GB) + "
                f"reserve {LM_RESERVE / 1e9:.1f} GB = {mem['need'] / 1e9:.1f} GB of the "
                f"card's {total / 1e9:.1f} GB; {layers + 1} layers would need "
                f"{mem['next_need'] / 1e9:.1f} GB (full depth: {full:.1f} GB of bf16 "
                f"weights)")
        else:
            cuts.append(f"depth {layers} of {cfg.n_layers} layers (kept; {fit} would fit)")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if cfg.moe is not None:
        cuts.append(f"capacity_factor {cfg.moe.capacity_factor} -> {cfg.moe.n_experts} "
                    f"(drop-free)")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    return cfg, "; ".join(cuts) or "none"


class Probe(Smoke):
    """Prints what each check reads and gates nothing."""

    def check(self, ok: bool, what: str) -> None:
        print(("probe within  " if ok else "probe over    ") + what, flush=True)


def run_lm_archs(device, archs=LM_ARCHS, grid=LM_ARCH_GRID, witness=LM_F32_WITNESS,
                 probe=LM_PROBE, seed=0):
    """Phase 8d: each arch served through ``ServingEngine`` and held
    against a plain ``forward``, ``decode_attn`` first held against its
    plain version at the arch's served shapes; then each witness arch
    again in f32 at the same depth, its distance from the forward
    closing there; then each probe arch at the most layers that fit,
    ungated.  Returns (stats by run, decode_attn launches, failures)."""
    import torch

    smoke, ungated = Smoke(), Probe()
    total = torch.cuda.get_device_properties(device).total_memory
    print(f"lm archs: the card's {total} bytes, {torch.cuda.mem_get_info(device)[0]} free, "
          f"{torch.cuda.memory_allocated(device)} allocated", flush=True)
    gen = torch.Generator().manual_seed(seed + 5)
    depths = dict(archs)
    runs = ([(name, depth, None, "") for name, depth in archs]
            + [(name, depths[name], "float32", " f32 witness") for name in witness]
            + [(name, None, None, " probe") for name in probe])
    out, launches = {}, 0
    for name, depth, dtype, role in runs:
        t = time.perf_counter()
        cfg, cuts = lm_arch_config(name, total, slots=grid["slots"], max_seq=grid["max_seq"],
                                   depth=depth, dtype=dtype)
        key = name + role
        gate = ungated if role == " probe" else smoke
        print(f"lm {key}: cuts: {cuts}; {cfg.param_count()} parameters", flush=True)
        if global_attention_layers(cfg):
            a = cfg.attn
            check_decode_attn(smoke, device, gen, [(
                f"{key}, served", grid["slots"], grid["max_seq"], a.n_kv_heads,
                a.n_heads // a.n_kv_heads, a.head_dim, cfg.dtype)], timed=False)
        model, params, engine, reqs, counts, stats, routes = serve_lm(
            gate, device, cfg, seed=seed, **grid)
        launches += counts["decode_attn"]
        stats.update(cuts=cuts, layers=cfg.n_layers)
        out[key] = time_lm(gate, device, model, params, engine, reqs, stats, routes,
                           slots=grid["slots"], max_seq=grid["max_seq"])
        del model, params, engine, reqs, routes
        _free(device)
        print(f"lm {key} phase: {time.perf_counter() - t:.1f} s", flush=True)
    for name in witness:
        lo, hi = out[name], out[name + " f32 witness"]
        keys = ["worst_gap"] + (["router_logit_err"] if "router_logit_err" in lo else [])
        print(f"lm {name} f32 witness at {lo['layers']} layers (bf16, f32): " + "; ".join(
            f"{k} {lo[k]:.6f}, {hi[k]:.6f}" for k in keys + ["decode_step_err"])
            + "".join(f"; {k} {lo[k]}, {hi[k]}" for k in ("exact", "routing_flips")
                      if k in lo), flush=True)
        smoke.check(hi["layers"] == lo["layers"] and all(hi[k] <= lo[k] / 10 for k in keys)
                    and hi.get("routing_flips", 0) <= lo.get("routing_flips", 0),
                    f"lm {name}: at the same depth the served decode's distance from the "
                    f"forward closes in f32 ({', '.join(keys)} at most a tenth of bf16's, no "
                    f"more routing flips): bf16 rounding, not the port")
    return out, launches, smoke.failures


# ---------------------------------------------------------------------------
# Phase 8e: the VLM patch frontend, the encoder-decoder and LM training

# the patch path, which ServingEngine does not reach (it prefills tokens
# only, as the reference's): (patches, prompt tokens, decode gated).  With
# 8 patches (the reference's test setting) the decode's M-RoPE ids
# continue the prefill's; with the stub's 256 they do not (the reference's
# decode gives the next token the id ``lengths``, its forward 8 + i - 256:
# layers/stubs.py), so only the prefill is gated there
VLM_PATCH_RUNS = ((8, 64, True), (256, 300, False))
VLM_NEW = 16
# whisper-tiny at full width: one prefill a request (each its own frames),
# packed into a 4-slot cache of the decoder's 448 positions, then greedy
# decode steps
WHISPER = dict(requests=4, prompt_range=(16, 65), cache_len=448, steps=32)
# whisper's own logit limits (LOGIT_TOL is Qwen2.5-14B's 48 bf16 layers;
# whisper's logit rows have a std of 0.39, their maximum 1.69 above the
# mean).  Sound readings (NVIDIA H100 80GB HBM3, 700 W): served gap 0.0000,
# the fixed-cache step 0.0117 in bf16 and 7.3e-07 in float32.  With each
# fault of DA_FAULTS planted in decode_attn's kernel route (same card) the
# step read 0.0312 / 0.5566 / 0.1309 / 1.5703 in bf16 and 0.0264 / 0.5524
# / 0.1284 / 1.5704 in float32 (bf16 rounding hides the newest row left
# out, float32 does not), and decoded with another request's cache the
# served gap read 0.3125
WHISPER_LOGIT_TOL = 0.05
WHISPER_F32_TOL = 1e-3
# faults planted in decode_attn's kernel route, which the float32 check
# must see: the newest row left out, another request's cache, every row
# read one place late, keys and values swapped
DA_FAULTS = ("short", "slot", "row", "kv")
# LM training: cross_entropy at qwen2-vl's vocabulary (S no multiple of
# 512) against float64, then whisper-tiny at full width trained 30 steps,
# and again 20 steps, a checkpoint, and 10 resumed; then the reference's
# own training check (tests/test_train_and_checkpoint.py: qwen1.5-4b
# reduced, batch 4, seq 64, lr 3e-3) the same way
CE_SHAPE = dict(B=2, S=600)
# cross_entropy against float64: the value within rtol 1e-5 (an f32 sum
# of V exponentials); the gradient within 1e-6 of its largest entry plus
# rtol 1e-5 in f32, rtol 2^-8 in bf16 (its own rounding)
CE_TOL = {"float32": dict(value_rtol=1e-5, grad_atol=1e-6, grad_rtol=1e-5),
          "bfloat16": dict(value_rtol=1e-5, grad_atol=1e-6, grad_rtol=2 ** -8)}
# whisper's falling loss is printed, not gated: at this setting the
# reference's own train_loop rises as the port's does (on the CPU the mean
# of its first five losses 10.9002, of its last five 10.9871; the port on
# an NVIDIA H100 80GB HBM3 at 700 W 10.8979 and 10.9733), and no other
# setting tried (lr 1e-4 to 1e-3, batch up to 64 x 448) fell by more than
# the step-to-step spread: a batch holds few of the 51,865 tokens, once,
# and Adam's first steps move every weight by about lr whatever its
# gradient.
# The fall is gated on the reference's own check (qwen1.5-4b reduced:
# 256 tokens, every batch covers them all); both are held to float64's
# gradient (``grad_vs_f64``)
LM_TRAIN = (dict(arch="whisper-tiny", reduced=False, steps=30, batch=8, seq=128, lr=1e-3,
                 restart=20, gate_fall=False),
            dict(arch="qwen1.5-4b", reduced=True, steps=30, batch=4, seq=64, lr=3e-3,
                 restart=20, gate_fall=True))
# the reference's restarted run's tolerance (tests/test_train_and_checkpoint.py)
RESTART_RTOL = 1e-4
# the trained model's next loss and gradient (bf16 weights, f32
# accumulation) against float64's: sound readings (NVIDIA H100 80GB HBM3,
# 700 W) loss 1.2e-05 / 3.9e-06 and gradient 0.0034 / 0.0116 relative
# (whisper-tiny / qwen1.5-4b reduced); half the batch's gradient 1.0062 /
# 1.0121
TRAIN_F64_RTOL = 0.05
TRAIN_F64_LOSS_RTOL = 1e-4


def patch_path(smoke, device, model, params, n_patches, prompt_len, new, gated, gen, seed):
    """``Model.prefill`` with ``n_patches`` patch embeddings, then ``new``
    greedy ``decode_step``s; the prefill's logits against ``forward``'s,
    and every token's logit against its row's maximum in ``forward`` on
    the grown sequence (gated with ``gated``, printed without); then the
    decode tick timed and profiled on the final caches (``time_tick``).
    Returns the stats and the decode's launch counts."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.layers.dot import f32_accumulation

    cfg = model.cfg
    B = 2
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(B, prompt_len)), dtype=torch.long,
                           device=device)
    pe = (torch.randn((B, n_patches, cfg.d_model), generator=gen, device=device) * 0.02
          ).to(getattr(torch, cfg.dtype))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with f32_accumulation():
        # one row past the decode's for the timed ticks (each writes that row)
        logits, caches = model.prefill(params, {"tokens": toks, "patch_embeds": pe},
                                       cache_len=prompt_len + new + 1)
        out = [logits[:, -1].argmax(-1)[:, None]]
        _sync(device)
        kernels.reset_launch_counts()
        t = time.perf_counter()
        for _ in range(new):
            lg, caches = model.decode_step(params, out[-1], caches)
            out.append(lg[:, 0].argmax(-1)[:, None])
        _sync(device)
        dt = time.perf_counter() - t
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        tick_ms, _, busy, da_ms = time_tick(
            lambda: model.decode_step(params, out[-1], caches), device,
            f"one decode tick of {cfg.name}, {n_patches} patches, {B} sequences")
        grown = torch.cat([toks] + out[:-1], dim=1)
        full, _ = model.forward(params, {"tokens": grown, "patch_embeds": pe}, remat=False)
    rows = full[:, prompt_len - 1:].float()
    served = torch.cat(out, dim=1)
    gap = rows.max(dim=-1).values - rows.gather(-1, served[..., None])[..., 0]
    prefill_err = float((logits.float() - full[:, :prompt_len].float()).abs().max())
    label = f"vlm {cfg.name} patches {n_patches}"
    smoke.check(prefill_err <= LOGIT_TOL,
                f"{label}: prefill logits vs forward over {prompt_len} positions: max_abs_err "
                f"{prefill_err:.4f} (atol {LOGIT_TOL}); the prefill token's gap "
                f"{float(gap[:, 0].max()):.4f}")
    worst = float(gap[:, 1:].max())
    exact = int((gap[:, 1:] == 0).sum())
    what = (f"{label}: {new} decoded tokens x {B} sequences within {LOGIT_TOL} of their "
            f"row's maximum in a forward on the grown sequence: worst gap {worst:.4f}, "
            f"{exact} of {B * new} the forward's argmax")
    if gated:
        smoke.check(worst <= LOGIT_TOL, what)
        n_global = global_attention_layers(cfg)
        smoke.check(counts["decode_attn"] == n_global * new > 0,
                    f"{label}: decode_attn launched {counts['decode_attn']} times == "
                    f"{n_global} layers x {new} decode steps")
    else:
        print(f"not gated (the decode's M-RoPE ids do not continue the prefill's, as in "
              f"the reference): {what}", flush=True)
    stats = dict(patches=n_patches, prompt=prompt_len, prefill_err=prefill_err, worst_gap=worst,
                 exact=exact, decode_s=dt, tokens_per_s=B * new / dt, tick_ms=tick_ms,
                 tick_busy_ms=busy * 1e3, tick_decode_attn_ms=da_ms, max_memory_allocated=peak,
                 decode_attn_launches=counts["decode_attn"])
    print(f"{label}: " + json.dumps(stats), flush=True)
    return stats, counts


@contextlib.contextmanager
def planted_decode_attn_fault(kind):
    """``decode_attn``'s kernel route, while the block runs, given a fault
    (``DA_FAULTS``); its plain route (``use_kernels=False``) untouched."""
    from repro_torch.kernels.decode_attn import ops

    sound = ops.decode_attn

    def faulty(q, k, v, lengths, *, use_kernels=None):
        if use_kernels is not False:
            if kind == "short":
                lengths = lengths - 1
            elif kind == "slot":
                k, v = k.roll(1, 0), v.roll(1, 0)
            elif kind == "row":
                k, v = k.roll(1, 1), v.roll(1, 1)
            elif kind == "kv":
                k, v = v, k
        return sound(q, k, v, lengths, use_kernels=use_kernels)

    ops.decode_attn = faulty
    try:
        yield
    finally:
        ops.decode_attn = sound


def serve_whisper(smoke, device, cfg, *, requests, prompt_range, cache_len, steps, seed=0):
    """Whisper served by hand: each request prefilled with its own frames
    (``Model.prefill``), its caches packed into a slot, then ``steps``
    greedy ``decode_step``s of all slots with the launch counts zeroed
    before and read after; each token within ``WHISPER_LOGIT_TOL`` of its
    row's maximum in ``forward`` on the grown sequence; one decode step
    with the kernel against one with the plain version on a fixed cache,
    in bf16 (``WHISPER_LOGIT_TOL``) and in float32 (``WHISPER_F32_TOL``);
    both again with each of ``DA_FAULTS`` planted, where the float32 check
    must fail, and the served decode with the cache of another request,
    where the served check must fail; the tick timed on the host and
    profiled.  Returns (stats, counts)."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.layers.dot import f32_accumulation
    from repro_torch.models import build_model
    from repro_torch.optim import tree

    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen, device=device)
    dt_ = getattr(torch, cfg.dtype)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, size=(int(rng.integers(*prompt_range)),))
               for _ in range(requests)]
    frames = [(torch.randn((1, cfg.enc_seq, cfg.d_model), generator=gen, device=device)
               * 0.05).to(dt_) for _ in prompts]
    print(f"lm: {cfg.name}, {cfg.n_enc_layers} + {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.attn.n_heads} heads on {cfg.attn.n_kv_heads} kv heads, {cfg.enc_seq} frames, "
          f"vocab {cfg.vocab}, {cfg.dtype}: {cfg.param_count()} parameters; prompts "
          f"{[len(p) for p in prompts]}, cache {cache_len}", flush=True)
    caches = model.make_caches(requests, cache_len, device=device)
    nxt = torch.zeros((requests, 1), dtype=torch.long, device=device)

    def copy(c, dtype=None):
        return {"dec": {k: x.to(dtype or x.dtype, copy=True) for k, x in c["dec"].items()},
                "lengths": c["lengths"].clone()}

    def decode(c):
        out = [nxt]
        for _ in range(steps):
            lg, c = model.decode_step(params, out[-1], c)
            out.append(lg[:, 0].argmax(-1)[:, None])
        return torch.cat(out, dim=1), c  # (requests, steps + 1)

    def gaps(served):
        """(worst gap, argmax count, mean row std, mean top minus mean)."""
        worst, exact, sigma, spread = 0.0, 0, 0.0, 0.0
        for b, (p, fe) in enumerate(zip(prompts, frames)):
            toks = torch.as_tensor(p, dtype=torch.long, device=device)[None]
            grown = torch.cat([toks, served[b:b + 1, :-1]], dim=1)
            full, _ = model.forward(params, {"tokens": grown, "frame_embeds": fe}, remat=False)
            rows = full[0, len(p) - 1:].float()
            top = rows.max(dim=-1).values
            gap = top - rows.gather(1, served[b][:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            exact += int((gap == 0).sum())
            sigma += float(rows.std(dim=-1).sum())
            spread += float((top - rows.mean(dim=-1)).sum())
        n = served.numel()
        return worst, exact, sigma / n, spread / n

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with f32_accumulation():
        t = time.perf_counter()
        for b, (p, fe) in enumerate(zip(prompts, frames)):
            toks = torch.as_tensor(p, dtype=torch.long, device=device)[None]
            lg, one = model.prefill(params, {"tokens": toks, "frame_embeds": fe},
                                    cache_len=cache_len)
            for key, c in one["dec"].items():
                caches["dec"][key][:, b].copy_(c[:, 0])
            caches["lengths"][b] = one["lengths"][0]
            nxt[b, 0] = lg[0, -1].argmax()
        _sync(device)
        prefill_s = time.perf_counter() - t
        start = copy(caches)
        kernels.reset_launch_counts()
        t = time.perf_counter()
        served, caches = decode(caches)
        _sync(device)
        decode_s = time.perf_counter() - t
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    smoke.check(counts["decode_attn"] == cfg.n_layers * steps > 0,
                f"lm {cfg.name}: decode_attn launched {counts['decode_attn']} times == "
                f"{cfg.n_layers} decoder layers x {steps} decode steps")
    with f32_accumulation():
        worst, exact, sigma, spread = gaps(served)
        with planted_decode_attn_fault("slot"):
            slot_worst = gaps(decode(start)[0])[0]
    smoke.check(worst <= WHISPER_LOGIT_TOL < slot_worst,
                f"lm {cfg.name}: every served token ({requests} x {steps + 1}) within "
                f"{WHISPER_LOGIT_TOL} of its row's maximum in a forward on the grown sequence: "
                f"worst gap {worst:.4f}; {exact} are the forward's argmax; logit rows' std "
                f"{sigma:.4f}, top minus mean {spread:.4f}; decoded with another request's "
                f"cache (a planted fault) the worst gap reads {slot_worst:.4f}")

    # the same step in float32 (weights and caches cast), where bf16
    # rounding no longer hides a fault that moves the logits a little
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = tree.unflatten(params, [t.float() for t in tree.leaves(params)])
    tok = served[:, -1:]

    def step_err(fault=None):
        """(bf16, float32) max abs err of one decode step on a copy of the
        final caches, the default route (the kernel on the card; with
        ``fault`` planted) vs the plain one."""
        errs = []
        for m, p, dtype in ((model, params, None), (model32, params32, torch.float32)):
            with contextlib.ExitStack() as stack:
                if fault:
                    stack.enter_context(planted_decode_attn_fault(fault))
                got, _ = m.decode_step(p, tok, copy(caches, dtype), use_kernels=None)
            want, _ = m.decode_step(p, tok, copy(caches, dtype), use_kernels=False)
            errs.append(float((got.float() - want.float()).abs().max()))
        return errs

    with f32_accumulation():
        step_bf16, step_f32 = step_err()
        faults = {kind: step_err(kind) for kind in DA_FAULTS}
    del model32, params32
    smoke.check(step_bf16 <= WHISPER_LOGIT_TOL and step_f32 <= WHISPER_F32_TOL,
                f"lm {cfg.name}: decode_step logits with the kernel vs the plain version on a "
                f"fixed cache (lengths {caches['lengths'].tolist()}): max_abs_err "
                f"{step_bf16:.4f} in bf16 (atol {WHISPER_LOGIT_TOL}), {step_f32:.3e} in float32 "
                f"(atol {WHISPER_F32_TOL})")
    smoke.check(all(f32 > WHISPER_F32_TOL for _, f32 in faults.values()),
                f"lm {cfg.name}: the same step with a fault planted in decode_attn's kernel "
                f"route reads above {WHISPER_F32_TOL} in float32: " + "; ".join(
                    f"{kind} {f32:.3e} (bf16 {bf:.4f})" for kind, (bf, f32) in faults.items()))

    def tick():
        return model.decode_step(params, tok, caches)

    with f32_accumulation():
        tick_ms, wall, busy, da_ms = time_tick(tick, device, f"one decode tick of {cfg.name}, "
                                                             f"{requests} slots")
    generated = requests * steps
    stats = dict(prefill_s=prefill_s, decode_s=decode_s, tokens_per_s=generated / decode_s,
                 tick_ms=tick_ms, tick_busy_ms=busy * 1e3, tick_decode_attn_ms=da_ms,
                 decode_attn_launches=counts["decode_attn"], max_memory_allocated=peak,
                 worst_gap=worst, exact=exact, total=served.numel(), logit_std=sigma,
                 logit_top_minus_mean=spread, slot_fault_worst_gap=slot_worst,
                 decode_step_err=step_bf16, decode_step_f32_err=step_f32,
                 fault_step_errs={k: dict(bf16=bf, f32=f32) for k, (bf, f32) in faults.items()})
    print(f"lm {cfg.name}: decode tick {tick_ms:.3f} ms on the host clock, {busy * 1e3:.3f} ms "
          f"of device time, decode_attn {da_ms:.3f} ms of it; " + json.dumps(stats),
          flush=True)
    return stats, counts


def check_cross_entropy(smoke, device, gen, V, B, S):
    """``cross_entropy`` and its gradient (``torch.autograd.grad``) on f32
    and bf16 logits against a float64 ``log_softmax``/``gather`` loss and
    its autograd gradient, at ``CE_TOL``; timed forward + backward."""
    import torch

    from repro_torch.layers.embedding import cross_entropy

    out = {}
    for dt in ("float32", "bfloat16"):
        tol = CE_TOL[dt]
        logits = (torch.randn((B, S, V), generator=gen, device=device) * 2).to(getattr(torch, dt))
        labels = torch.randint(0, V, (B, S), generator=gen, device=device)
        lt = logits.detach().requires_grad_(True)
        ce = cross_entropy(lt, labels)
        (g,) = torch.autograd.grad(ce, lt)
        l64 = logits.double().requires_grad_(True)
        ce64 = -torch.log_softmax(l64, dim=-1).gather(-1, labels[..., None]).mean()
        (g64,) = torch.autograd.grad(ce64, l64)
        ce, ce64 = ce.detach(), ce64.detach()
        v_err = abs(float(ce) - float(ce64))
        g_err = (g.double() - g64).abs()
        atol = tol["grad_atol"] * float(g64.abs().max())
        g_ok = bool(torch.all(g_err <= atol + tol["grad_rtol"] * g64.abs()))
        del l64, g64

        def fwd_bwd():
            x = logits.detach().requires_grad_(True)
            torch.autograd.grad(cross_entropy(x, labels), x)

        ms = time_ms(fwd_bwd, device, reps=3)
        smoke.check(v_err <= tol["value_rtol"] * abs(float(ce64)) and g_ok and g.dtype == logits.dtype,
                    f"cross_entropy {dt} (B {B}, S {S}, V {V}) vs float64: value "
                    f"{float(ce):.6f} vs {float(ce64):.6f}, err {v_err:.3e} (rtol "
                    f"{tol['value_rtol']}); gradient max_abs_err {float(g_err.max()):.3e} "
                    f"(atol {tol['grad_atol']} x max|g64| = {atol:.3e}, rtol {tol['grad_rtol']}); "
                    f"forward + backward {ms:.3f} ms")
        out[dt] = dict(value_err=v_err, grad_err=float(g_err.max()), ms=ms)
        del logits, labels, lt, g, g_err
    return out


def grad_vs_f64(smoke, device, params, *, arch, reduced, batch, seq, seed, step):
    """The train step's gradient (``launch.train.loss_and_grads`` on
    ``make_batch``'s batch ``step``, at ``params``, under
    ``f32_accumulation`` as ``train_loop`` runs it) against the same
    model's loss and gradient in float64 on that batch, and against the
    gradient of half the batch (a fault the check must see).  Returns the
    relative errors of the loss and of the gradient's global norm."""
    from repro_torch.launch.train import build_run, loss_and_grads, make_batch
    from repro_torch.layers.dot import f32_accumulation
    from repro_torch.models import build_model
    from repro_torch.optim import tree

    cfg, model, pipe = build_run(arch, batch=batch, seq=seq, reduced=reduced, seed=seed)
    b = make_batch(cfg, pipe, step, seed=seed, device=device)
    with f32_accumulation():
        loss, grads = loss_and_grads(model, params, b)
        _, half = loss_and_grads(model, params, {k: v[:batch // 2] for k, v in b.items()})

    def f64(t):
        return t.double() if t.is_floating_point() else t

    model64 = build_model(dataclasses.replace(cfg, dtype="float64"))
    p64 = tree.unflatten(params, [f64(t) for t in tree.leaves(params)])
    loss64, g64 = loss_and_grads(model64, p64, {k: f64(v) for k, v in b.items()}, remat=False)
    del p64

    def rel(got):
        num = sum(float((a.double() - w).square().sum())
                  for a, w in zip(tree.leaves(got), tree.leaves(g64)))
        return math.sqrt(num) / math.sqrt(sum(float(w.square().sum()) for w in tree.leaves(g64)))

    loss_err = abs(float(loss) - float(loss64)) / abs(float(loss64))
    g_err, half_err = rel(grads), rel(half)
    label = f"train {arch}{' reduced' if reduced else ''}"
    smoke.check(loss_err <= TRAIN_F64_LOSS_RTOL and g_err <= TRAIN_F64_RTOL < half_err,
                f"{label}: step {step}'s loss and gradient (batch {batch}, {cfg.dtype}) vs "
                f"float64 at the trained params: loss {float(loss):.6f} vs "
                f"{float(loss64):.6f}, rel err {loss_err:.3e} (rtol {TRAIN_F64_LOSS_RTOL}); "
                f"gradient global-norm rel err "
                f"{g_err:.4f} (rtol {TRAIN_F64_RTOL}); half the batch's gradient reads "
                f"{half_err:.4f}")
    return dict(loss_f64_rel_err=loss_err, grad_f64_rel_err=g_err, half_batch_grad_rel_err=half_err)


def train_lm(smoke, device, *, arch, reduced, steps, batch, seq, lr, restart, gate_fall,
             seed=0):
    """``launch.train.train_loop`` for ``steps`` steps, then again for
    ``restart`` steps into a second directory and resumed to ``steps``:
    every loss finite, the resumed losses within ``RESTART_RTOL`` of the
    uninterrupted run's, the next step's gradient at the trained params
    within ``TRAIN_F64_RTOL`` of float64's (``grad_vs_f64``), and the loss
    falling (the mean of the first five above the last five's; gated with
    ``gate_fall``, printed without)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch.train import train_loop

    kw = dict(arch=arch, batch=batch, seq=seq, reduced=reduced, ckpt_every=restart, lr=lr,
              seed=seed, log_every=10, device=device)
    with tempfile.TemporaryDirectory() as work:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
        t = time.perf_counter()
        full = train_loop(steps=steps, ckpt_dir=os.path.join(work, "a"), **kw)
        _sync(device)
        full_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        train_loop(steps=restart, ckpt_dir=os.path.join(work, "b"), **kw)
        resumed = train_loop(steps=steps, ckpt_dir=os.path.join(work, "b"), **kw)
    losses = np.asarray(full["losses"])
    tail = np.asarray(resumed["losses"])
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    label = f"train {arch}{' reduced' if reduced else ''}"
    what = (f"{label}: {steps} steps (batch {batch}, seq {seq}, lr {lr}), mean of the first 5 "
            f"losses {first:.4f} > mean of the last 5 {last:.4f}")
    smoke.check(len(losses) == steps and bool(np.isfinite(losses).all()),
                f"{label}: {steps} losses, every one finite")
    if gate_fall:
        smoke.check(first > last, what)
    else:
        print(f"not gated (see LM_TRAIN): {what}: {first > last}", flush=True)
    f64 = grad_vs_f64(smoke, device, full["params"], arch=arch, reduced=reduced, batch=batch,
                      seq=seq, seed=seed, step=steps)
    rel = float(np.max(np.abs(tail - losses[restart:]) / np.abs(losses[restart:])))
    smoke.check(len(tail) == steps - restart and rel <= RESTART_RTOL,
                f"{label}: resumed from the step-{restart} checkpoint, its {len(tail)} "
                f"losses vs the uninterrupted run's: max rel err {rel:.3e} (rtol {RESTART_RTOL}); "
                f"bitwise equal: {bool(np.array_equal(tail, losses[restart:]))}")
    stats = dict(losses=[float(x) for x in losses], step_s=full_s / steps,
                 tokens_per_s=batch * seq * steps / full_s, max_memory_allocated=peak,
                 restart_rel_err=rel, **f64)
    print(f"{label}: {full_s / steps * 1e3:.1f} ms a step on the host clock (first step "
          f"included), max_memory_allocated {peak}; " + json.dumps(stats), flush=True)
    return stats


def run_lm_frontends(device, vlm_cfg, whisper_cfg, *, da_cases, grid, card="",
                     patch_runs=VLM_PATCH_RUNS, vlm_new=VLM_NEW, whisper=WHISPER,
                     ce_shape=CE_SHAPE, train=LM_TRAIN, seed=0):
    """Phase 8e: ``decode_attn`` held at the two new archs' decode shapes;
    qwen2-vl served through ``ServingEngine`` and checked as 8b-c, then
    its patch path; whisper served by hand; then LM training.  Returns
    (stats, decode_attn launches, failures)."""
    import torch

    smoke = Smoke()
    gen = torch.Generator().manual_seed(seed + 7)
    dgen = torch.Generator(device=device).manual_seed(seed + 11)
    out, launches = {}, 0
    for case in da_cases:
        r = check_decode_attn(smoke, device, gen, [case])
        out[f"decode_attn {case[0]}"] = r
    t = time.perf_counter()
    model, params, engine, reqs, counts, stats, routes = serve_lm(
        smoke, device, vlm_cfg, seed=seed, **grid)
    launches += counts["decode_attn"]
    out[vlm_cfg.name] = time_lm(smoke, device, model, params, engine, reqs, stats, routes,
                                slots=grid["slots"], max_seq=grid["max_seq"])
    del engine, reqs
    for n_patches, prompt_len, gated in patch_runs:
        st, c = patch_path(smoke, device, model, params, n_patches, prompt_len, vlm_new, gated,
                           dgen, seed)
        launches += c["decode_attn"]
        out[f"{vlm_cfg.name} patches {n_patches}"] = st
    del model, params
    _free(device)
    print(f"lm {vlm_cfg.name} phase: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    out[whisper_cfg.name], c = serve_whisper(smoke, device, whisper_cfg, seed=seed, **whisper)
    launches += c["decode_attn"]
    _free(device)
    print(f"lm {whisper_cfg.name} phase: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    out["cross_entropy"] = check_cross_entropy(smoke, device, dgen, vlm_cfg.vocab, **ce_shape)
    _free(device)
    for run in train:
        out[f"train {run['arch']}"] = train_lm(smoke, device, seed=seed, **run)
        _free(device)
    print(f"lm training phase: {time.perf_counter() - t:.1f} s", flush=True)
    print(f"lm frontends ({card}): " + json.dumps(out), flush=True)
    return out, launches, smoke.failures


# ---------------------------------------------------------------------------
# Phase 7: training on the card

# full-width n337 (80 maps, 10 layers) trained at m = 2 (input 100³),
# batch 2, with direct convs and mpf pools: the reference example's
# primitives (examples/train_segmentation.py); AdamW at its default lr
# (3e-4): at 1e-3 step 2's loss rose 7-fold over step 1's
TRAIN = dict(m=2, batch=2, steps=5, save_after=3, lr=3e-4, seg_steps=200)
# a gradient kernel against its plain version: atol 1e-4 of the plain
# result's largest magnitude, rtol 1e-4 (sums of up to 1.9 M fp32 products
# in another order; the small entries of a gradient are sums that cancel,
# so the scale is the tensor's largest entry); the losses of the kernel
# and the plain runs at rtol 1e-4, the reference's end-to-end rtol
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-4
# (label, S, f, f', n, k) of n337's convs at the training shapes: the
# input gradient runs through the conv3d kernel, the weight gradient
# through conv3d_wgrad; layers 7 and 8 repeat layer 6's kind
TRAIN_CONVS = (("layer 0", 2, 1, 80, 100, 2), ("layer 2", 16, 80, 80, 49, 3),
               ("layer 4", 128, 80, 80, 23, 3), ("layer 6", 1024, 80, 80, 10, 3),
               ("layer 9", 1024, 80, 3, 4, 3))
# (label, S, f, n) of n337's pools at the training shapes, p = 2
TRAIN_POOLS = (("layer 1", 2, 80, 99), ("layer 3", 16, 80, 47), ("layer 5", 128, 80, 21))
# ragged shapes (S, f, f', n, k): no multiple of any tile, k up to n926's 9
RAGGED_GRAD = (
    (1, 1, 1, (5, 5, 5), (1, 1, 1)), (2, 3, 5, (9, 11, 13), (3, 2, 4)),
    (3, 5, 7, (17, 17, 17), (3, 3, 3)), (1, 7, 9, (6, 20, 33), (2, 3, 5)),
    (4, 2, 13, (10, 9, 8), (4, 4, 4)), (2, 9, 3, (12, 7, 5), (5, 3, 2)),
    (5, 16, 16, (11, 11, 11), (3, 3, 3)), (1, 4, 6, (30, 4, 9), (2, 1, 3)),
    (3, 6, 1, (8, 8, 40), (3, 3, 3)), (2, 1, 20, (15, 14, 13), (2, 2, 2)),
    (7, 12, 5, (7, 7, 7), (7, 7, 7)), (1, 33, 17, (9, 10, 11), (3, 3, 3)),
    (1, 3, 4, (12, 12, 12), (9, 9, 9)), (9, 80, 80, (8, 9, 10), (3, 3, 3)),
    # conv3d_wgrad's tiles (PR 21): 128 or 256 rows of f*k^3, 8/16/40/80
    # columns of f', items of TY rows or TX whole planes: 2 x 2 tiles with
    # f' = 81, f*k^3 = 135 and 2160 (no multiple of 128), a partial row item,
    # items of one row wider than 256 positions, whole planes of 1^3 outputs
    (2, 5, 81, (9, 8, 7), (3, 3, 3)), (3, 80, 41, (11, 6, 13), (3, 3, 3)),
    (2, 2, 17, (6, 40, 30), (2, 2, 2)), (1, 1, 80, (4, 5, 301), (2, 2, 2)),
    (64, 80, 3, (3, 3, 3), (3, 3, 3)),
)
RAGGED_POOL = ((2, 3, (7, 9, 5), 2), (1, 5, (11, 11, 11), 3), (3, 4, (9, 5, 7), 2),
               (1, 2, (8, 5, 11), 3), (5, 80, (13, 15, 17), 2),
               # mpf_pool_bwd's tiles (PR 21: 8 x 8 x up to 62, 9 for p = 3)
               # cut windows on every axis: z in two and three tiles
               (2, 3, (17, 11, 71), 2), (1, 4, (11, 14, 131), 3), (1, 2, (9, 17, 129), 2))


def tie_free(shape, device, gen):
    """Values distinct inside every pooling window: a random permutation of
    2^22 levels repeated along the flat index (two voxels of one window lie
    closer than 2^22 apart there), so each window has one maximum."""
    import torch

    n, levels = math.prod(shape), 1 << 22
    perm = torch.randperm(levels, device=device, generator=gen)
    return (perm[torch.arange(n, device=device) % levels].to(torch.float32)
            / levels).reshape(shape)


def _grad_close(smoke, label, got, want):
    import torch

    scale = float(want.abs().max())
    ok, err = _close(got, want, atol=GRAD_TOL * scale, rtol=GRAD_TOL)
    smoke.check(ok and bool(torch.isfinite(got).all()),
                f"{label}: max_abs_err {err:.3e} (atol {GRAD_TOL} x max|plain| = "
                f"{GRAD_TOL * scale:.3e}, rtol {GRAD_TOL})")
    return err


def check_grad_kernels(smoke, device, gen, convs=TRAIN_CONVS, pools=TRAIN_POOLS,
                       ragged_grad=RAGGED_GRAD, ragged_pool=RAGGED_POOL):
    """Phase 7a: the input gradient (through ``conv3d``) and ``conv3d_wgrad``
    against the plain autograd of ``ref.conv3d`` at n337's training shapes,
    then ``mpf_pool_bwd`` against its plain version on tie-free inputs,
    each timed beside its bound and cuDNN's (the forward ``conv3d`` too,
    timed at the same shapes); then ragged shapes.  Returns
    the kernels line's entries (layer 2's conv, layer 1's pool)."""
    import torch

    from repro_torch.kernels.direct_conv3d import ops as cops
    from repro_torch.kernels.direct_conv3d import ref as cref
    from repro_torch.kernels.mpf_pool import ops as mops
    from repro_torch.kernels.mpf_pool import ref as mref

    results = {}
    errs = []
    for label, S, f, fp, n, k in convs:
        k3 = (k,) * 3
        x = torch.randn((S, f, n, n, n), device=device, generator=gen)
        w = torch.randn((fp, f) + k3, device=device, generator=gen) * (2.0 / (f * k**3)) ** 0.5
        npn = n - k + 1
        g = torch.randn((S, fp, npn, npn, npn), device=device, generator=gen)
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        with torch.enable_grad():
            out = cref.conv3d(xr, wr)
        dx_p, dw_p = torch.autograd.grad(out, (xr, wr), g)
        del out, xr, wr
        dx = cops.conv3d_dgrad(g, w)
        dw = cops.conv3d_wgrad(x, g, k3)
        shapes = f"x {tuple(x.shape)} w {tuple(w.shape)}"
        e_dx = _grad_close(smoke, f"conv3d input gradient ({label}), {shapes}", dx, dx_p)
        e_dw = _grad_close(smoke, f"conv3d_wgrad ({label}), {shapes}", dw, dw_p)
        smoke.check(torch.equal(dw, cops.conv3d_wgrad(x, g, k3)),
                    f"conv3d_wgrad ({label}): a second call is bitwise equal")
        errs.append(e_dw)
        del dx_p, dw_p
        flops = 2.0 * S * fp * f * k**3 * npn**3
        rows = {}
        # (name, kernel, plain, cuDNN, bytes, the route's peak and its
        # operations per FLOP): conv3d_wgrad runs 3xTF32 on the tensor cores
        # (three TF32 products a product), the conv3d kernel fp32 FMAs
        for name, fn, plain, lib, nbytes, peak, ops in (
                ("conv3d_wgrad", lambda: cops.conv3d_wgrad(x, g, k3),
                 lambda: cref.conv3d_wgrad(x, g, k3),
                 lambda: torch.nn.grad.conv3d_weight(x, w.shape, g), _nb(x) + _nb(g) + _nb(w),
                 PEAK_TF32, 3),
                ("input gradient", lambda: cops.conv3d_dgrad(g, w),
                 lambda: cref.conv3d_dgrad(g, w),
                 lambda: torch.nn.grad.conv3d_input(x.shape, w, g), _nb(g) + _nb(w) + _nb(x),
                 PEAK_FP32, 1),
                ("conv3d forward", lambda: cops.conv3d(x, w), lambda: cref.conv3d(x, w),
                 lambda: torch.nn.functional.conv3d(x, w), _nb(x) + _nb(w) + _nb(g),
                 PEAK_FP32, 1)):
            ms = time_ms(fn, device)
            plain_ms = time_ms(plain, device, reps=2)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                lib_ms = time_ms(lib, device)
            b_ms, b_by = bound(nbytes, ops * flops, peak)
            f_ms, f_by = bound(nbytes, flops)
            rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                              bound_by=b_by)
            route = (f"bound {b_ms:.3f} ms as 3xTF32 ({b_by}; {ops * flops / 1e9:.1f} GFLOP "
                     f"TF32 at {peak / 1e12:.0f} TFLOP/s), {100 * b_ms / ms:.1f}% of it; fp32 "
                     f"bound {f_ms:.3f} ms ({f_by}), {100 * f_ms / ms:.1f}%" if ops > 1 else
                     f"bound {b_ms:.3f} ms ({b_by}), {100 * b_ms / ms:.1f}% of bound")
            print(f"kernel {name} ({label}, {shapes}): {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"cuDNN (TF32 off) {lib_ms:.3f} ms; {flops / 1e9:.1f} GFLOP, "
                  f"{nbytes / 1e9:.3f} GB; {route}", flush=True)
            smoke.check(b_ms <= ms, f"kernel {name} ({label}): {ms:.3f} ms, no faster than "
                                    f"its route's bound {b_ms:.3f} ms")
        if label == convs[min(1, len(convs) - 1)][0]:
            results["conv3d_wgrad"] = dict(rows["conv3d_wgrad"])
            results["conv3d input gradient"] = dict(rows["input gradient"], max_abs_err=e_dx)
        del x, w, g, dx, dw
        _free(device)
    results["conv3d_wgrad"]["max_abs_err"] = max(errs)

    for S, f, fp, n, k in ragged_grad:
        x = torch.randn((S, f) + n, device=device, generator=gen)
        w = torch.randn((fp, f) + k, device=device, generator=gen)
        g = torch.randn((S, fp) + tuple(a - b + 1 for a, b in zip(n, k)), device=device,
                        generator=gen)
        shapes = f"x {tuple(x.shape)} w {tuple(w.shape)}"
        _grad_close(smoke, f"conv3d input gradient (ragged), {shapes}",
                    cops.conv3d_dgrad(g, w), cref.conv3d_dgrad(g, w))
        _grad_close(smoke, f"conv3d_wgrad (ragged), {shapes}",
                    cops.conv3d_wgrad(x, g, k), cref.conv3d_wgrad(x, g, k))

    pool_errs = []
    for label, S, f, n in pools:
        x = tie_free((S, f, n, n, n), device, gen)
        gy = torch.randn((S * 8, f) + (n // 2,) * 3, device=device, generator=gen)
        gx = mops.mpf_pool_bwd(x, gy, 2)
        want = mref.mpf_pool_bwd(x, gy, 2)
        xa = x.clone().requires_grad_(True)
        with torch.enable_grad():
            ya = mref.mpf_pool(xa, 2)
        (ga,) = torch.autograd.grad(ya, xa, gy)
        del xa, ya
        err = float((gx - want).abs().max())
        pool_errs.append(err)
        smoke.check(torch.equal(gx, want),
                    f"mpf_pool_bwd ({label}), x {tuple(x.shape)}: bitwise equal to its plain "
                    f"version (max_abs_err {err:.3e})")
        smoke.check(torch.equal(gx, mops.mpf_pool_bwd(x, gy, 2)),
                    f"mpf_pool_bwd ({label}): a second call is bitwise equal")
        _grad_close(smoke, f"mpf_pool_bwd ({label}) vs the autograd of the plain pool "
                           "(tie-free input)", gx, ga)
        ms = time_ms(lambda: mops.mpf_pool_bwd(x, gy, 2), device)
        plain_ms = time_ms(lambda: mref.mpf_pool_bwd(x, gy, 2), device, reps=2)
        b_ms, b_by = bound(_nb(x) + _nb(gy) + _nb(gx), 0.0)
        print(f"kernel mpf_pool_bwd ({label}, x {tuple(x.shape)}, p 2): {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), {100 * b_ms / ms:.1f}% of "
              "bound; no PyTorch call gives every fragment's gradient", flush=True)
        smoke.check(b_ms <= ms, f"kernel mpf_pool_bwd ({label}): {ms:.3f} ms, no faster than "
                                f"its bound {b_ms:.3f} ms")
        if label == pools[0][0]:
            results["mpf_pool_bwd"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                           bound_ms=b_ms, bound_by=b_by)
        del x, gy, gx, want, ga
        _free(device)
    for S, f, n, p in ragged_pool:
        x = tie_free((S, f) + n, device, gen)
        gy = torch.randn((S * p**3, f) + tuple(a // p for a in n), device=device,
                         generator=gen)
        got, want = mops.mpf_pool_bwd(x, gy, p), mref.mpf_pool_bwd(x, gy, p)
        err = float((got - want).abs().max())
        pool_errs.append(err)
        smoke.check(torch.equal(got, want), f"mpf_pool_bwd (ragged), x {tuple(x.shape)}, "
                                            f"p {p}: bitwise equal (max_abs_err {err:.3e})")
    results["mpf_pool_bwd"]["max_abs_err"] = max(pool_errs)
    return results


def _leaves_close(smoke, label, got, want):
    from repro_torch.optim import tree

    gl, wl = tree.leaves(got), tree.leaves(want)
    smoke.check(len(gl) == len(wl) == 14 and all(g is not None for g in gl),
                f"{label}: {len(gl)} parameter gradients, every one present (7 convs' w and b)")
    return max(_grad_close(smoke, f"{label}, leaf {i} {tuple(g.shape)}", g, w)
               for i, (g, w) in enumerate(zip(gl, wl)))


def _clone(t):
    from repro_torch.optim import tree

    return tree.unflatten(t, [x.clone() for x in tree.leaves(t)])


def _pool_at(h, p, args):
    """The MPF fragments of h taking each window's value at the tap
    ``args[o]`` names (o in fragment order): the pool on given branches."""
    import itertools

    import torch

    S, f = h.shape[:2]
    m = [n // p for n in h.shape[2:]]
    frags = []
    for o, (ox, oy, oz) in enumerate(itertools.product(range(p), repeat=3)):
        v = h[:, :, ox:ox + p * m[0], oy:oy + p * m[1], oz:oz + p * m[2]]
        v = v.reshape(S, f, m[0], p, m[1], p, m[2], p).permute(0, 1, 2, 4, 6, 3, 5, 7)
        v = v.reshape(S, f, *m, p**3)
        frags.append(torch.gather(v, -1, args[o].long().unsqueeze(-1))[..., 0])
    return torch.stack(frags, dim=1).reshape(S * p**3, f, *m)


def forward_branches(params, net, x, precision):
    """The branches one forward of the train cell takes: per ReLU the mask
    of positive pre-activations, per pool each fragment's window argmax (the
    first maximum in tap order), as int8 (p³, S, f, m³).  ``precision``:
    "kernels" (the fp32 kernel path), "plain" (the fp32 plain versions) or
    "float64" (cuDNN's conv3d, TF32 off)."""
    import itertools

    import torch
    import torch.nn.functional as F

    from repro_torch.core.bias import add_channel_bias
    from repro_torch.kernels.direct_conv3d import ops as cops
    from repro_torch.kernels.mpf_pool import ops as mops

    uk = None if precision == "kernels" else False
    last = max(i for i, layer in enumerate(net.layers) if layer.kind == "conv")
    out = []
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        h = x.to(torch.float64 if precision == "float64" else torch.float32)
        for i, layer in enumerate(net.layers):
            if layer.kind == "conv":
                w, b = params[i]
                if precision == "float64":
                    h = F.conv3d(h, w.to(torch.float64), b.to(torch.float64))
                else:
                    h = add_channel_bias(cops.conv3d(h, w, use_kernels=uk), b)
                if i != last:
                    out.append(h > 0)
                    h = torch.relu(h)
            else:
                p = layer.size
                m = [n // p for n in h.shape[2:]]
                args = []
                for ox, oy, oz in itertools.product(range(p), repeat=3):
                    v = h[:, :, ox:ox + p * m[0], oy:oy + p * m[1], oz:oz + p * m[2]]
                    v = v.reshape(*v.shape[:2], m[0], p, m[1], p, m[2], p)
                    args.append(v.permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(
                        *v.shape[:2], *m, p**3).argmax(-1).to(torch.int8))
                out.append(torch.stack(args))
                h = mops.mpf_pool(h, p, use_kernels=False if precision == "float64" else uk)
    return out


def branch_flips(a, b) -> int:
    """Places where two forwards' branches (``forward_branches``) differ."""
    return sum(int((u != v).sum()) for u, v in zip(a, b))


def grads_f64(params, net, x, y, branches=None):
    """The train cell's gradients at ``params`` in float64: cuDNN's conv3d
    (TF32 off) and the plain pool (``MpfPoolFn`` on ``ref.mpf_pool`` and
    ``ref.mpf_pool_bwd``, the kernels' first-maximum rule) under autograd,
    the example's BCE computed in float64.  With ``branches`` (an fp32
    forward's, ``forward_branches``) every ReLU and pool follows that
    forward's branches instead of its own, so the result differs from that
    forward's gradients by their arithmetic alone.  A check, not a path of
    the port."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.mpf import recombine_fragments
    from repro_torch.kernels.mpf_pool.ops import MpfPoolFn
    from repro_torch.optim import tree

    leaves = [p.detach().to(torch.float64).requires_grad_(True) for p in tree.leaves(params)]
    p64 = tree.unflatten(params, leaves)
    last = max(i for i, layer in enumerate(net.layers) if layer.kind == "conv")
    taken = iter(branches or ())
    pools = []
    with torch.enable_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        h = x.to(torch.float64)
        for i, layer in enumerate(net.layers):
            if layer.kind == "conv":
                h = F.conv3d(h, *p64[i])
                if i != last:
                    h = h.masked_fill(~next(taken), 0.0) if branches else torch.relu(h)
            else:
                h = (_pool_at(h, layer.size, next(taken)) if branches
                     else MpfPoolFn.apply(h, layer.size, False))
                pools.append(layer.size)
        z = recombine_fragments(h, pools, x.shape[0])
        t = y.to(torch.float64)
        loss = torch.mean(torch.clamp(z, min=0) - z * t + torch.log1p(torch.exp(-z.abs())))
        grads = torch.autograd.grad(loss, leaves)
    return tree.unflatten(params, list(grads))


# the gradient gate of train steps 2-5, per leaf, against the float64
# gradients at the same params along the kernels' own branches:
#   |g - g64| <= F64_TOL * max|g64| + F64_ATOL
# (the CPU test's formula, tests/test_torch_training.py).  Along the
# kernels' own branches g64 differs from the kernels' gradients by their
# arithmetic alone; against float64's own branches it also differs by every
# ReLU and pool window the fp32 forward takes the other way, each moving a
# gradient term whole (PR 21: 199-277 such places a step for the kernel
# path, 55-78 for the plain versions), which even the fp32 plain versions
# do not meet at steps 3-4.  Both comparisons are printed.
F64_TOL, F64_ATOL = 1e-4, 1e-6


def f64_gate(smoke, step, params, net, x, y, grads, plain, gate: bool):
    """Hold the kernels' gradients ``grads`` at ``params`` against float64
    ones along the kernels' branches (with ``gate``), and print, per leaf as
    max_abs_err / max|g64|, the kernels' and the fp32 plain versions'
    (``plain``) errors against float64 on float64's own branches and on
    each forward's own, with the count of branches each forward takes
    apart from float64's.  Returns the kernels' largest error over its
    leaf's tolerance."""
    import torch

    from repro_torch.optim import tree

    t = time.perf_counter()
    br = {k: forward_branches(params, net, x, k) for k in ("kernels", "plain", "float64")}
    print(f"train step {step}: ReLU and pool branches apart from float64's: kernels "
          f"{branch_flips(br['kernels'], br['float64'])}, fp32 plain "
          f"{branch_flips(br['plain'], br['float64'])} (kernels from plain "
          f"{branch_flips(br['kernels'], br['plain'])})", flush=True)
    g64 = tree.leaves(grads_f64(params, net, x, y))
    gk64 = tree.leaves(grads_f64(params, net, x, y, branches=br["kernels"]))
    gp64 = tree.leaves(grads_f64(params, net, x, y, branches=br["plain"]))
    del br
    gl, pl = tree.leaves(grads), tree.leaves(plain)

    def rel(a, b):
        b = b.to(torch.float32)
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    for what, ref_k, ref_p in (("float64's own branches", g64, g64),
                               ("each forward's own branches", gk64, gp64)):
        print(f"train step {step} gradients vs float64 on {what}: max_abs_err / max|g64| by "
              "leaf, kernels | fp32 plain: " + ", ".join(
                  f"{rel(a, c):.2e} | {rel(b, d):.2e}"
                  for a, b, c, d in zip(gl, pl, ref_k, ref_p)), flush=True)
    worst = 0.0
    for i, (g, w) in enumerate(zip(gl, gk64)):
        w = w.to(torch.float32)
        err, tol = float((g - w).abs().max()), F64_TOL * float(w.abs().max()) + F64_ATOL
        worst = max(worst, err / tol)
        if gate:
            smoke.check(err <= tol and bool(torch.isfinite(g).all()),
                        f"train step {step} gradients, leaf {i} {tuple(g.shape)} vs float64 on "
                        f"the kernels' branches: max_abs_err {err:.3e} <= {F64_TOL} x max|g64| "
                        f"+ {F64_ATOL} = {tol:.3e}")
    print(f"train step {step}: float64 oracles {time.perf_counter() - t:.1f} s", flush=True)
    return worst


def train_n337(smoke, device, net, counts, train=TRAIN):
    """Phase 7b–c: full-width n337 takes AdamW steps through the kernels,
    each step's loss and gradients held against the plain versions at the
    same params; then the plain versions' own run from the same initial
    params; a checkpoint after step 3 is restored into fresh objects and
    steps 4–5 rerun, bitwise; one step each with bf16 and int8 moments."""
    import tempfile

    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch import kernels
    from repro_torch.core import convnet
    from repro_torch.data import SyntheticVolumePipeline, VolumePipelineConfig
    from repro_torch.examples.train_segmentation import labels_of, loss_and_grads, train_step
    from repro_torch.optim import AdamWConfig, QTensor, apply_updates, init_state, tree

    cuda = device.type == "cuda"
    n_in = net.valid_input_size(train["m"])
    fov = net.field_of_view()
    n_out = n_in - fov + 1
    prims = ["direct" if l.kind == "conv" else "mpf" for l in net.layers]
    pipe = SyntheticVolumePipeline(VolumePipelineConfig(patch=n_in, batch=train["batch"]))
    batches = []
    for s in range(train["steps"]):
        x = torch.from_numpy(pipe.batch_at(s)).to(device)
        batches.append((x, labels_of(x, fov, n_out)))
    cfg = AdamWConfig(lr=train["lr"])
    params0 = convnet.init_params(net, torch.Generator().manual_seed(0), device=device)
    print(f"train: {net.name}, {sum(t.numel() for t in tree.leaves(params0))} parameters, "
          f"input {tuple(batches[0][0].shape)}, dense output {(train['batch'], 3) + (n_out,) * 3}, "
          f"prims {prims}, AdamW lr {cfg.lr}", flush=True)

    # the bytes autograd holds for the backward: one forward, loss kept
    _free(device)
    base = torch.cuda.memory_allocated(device) if cuda else 0
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params0)]
    with torch.enable_grad():
        loss = convnet.apply_plan(tree.unflatten(params0, leaves), net, batches[0][0],
                                  prims).sum()
    saved = torch.cuda.memory_allocated(device) - base if cuda else 0
    del loss, leaves
    print(f"train: {saved} B held for the backward after one forward "
          f"(the saved activations)", flush=True)

    f64_worst = []  # each step's largest error over its F64 tolerance

    def run(params, opt, steps, use_kernels, work=None, against_plain=False):
        """Steps ``steps`` from (params, opt); with ``against_plain`` each
        step's loss is held against the plain versions at the same params
        (outside the timed step), and so are step 1's gradients; every
        step's gradients are compared with float64 ones at the same params
        (``grads_f64``), and from step 2 on held to the F64 gate."""
        losses, grads0, host, dev_ms, th, peak = [], None, [], [], None, 0
        for s in steps:
            if cuda:
                ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda.reset_peak_memory_stats(device)
            _sync(device)
            t = time.perf_counter()
            if cuda:
                ev0.record()
            before = params
            loss, grads = loss_and_grads(params, net, prims, *batches[s],
                                         use_kernels=use_kernels)
            params, opt = apply_updates(params, grads, opt, cfg)
            if cuda:
                ev1.record()
            _sync(device)
            host.append((time.perf_counter() - t) * 1e3)
            dev_ms.append(ev0.elapsed_time(ev1) if cuda else float("nan"))
            peak = max(peak, torch.cuda.max_memory_allocated(device) if cuda else 0)
            losses.append(loss)
            if grads0 is None:
                grads0 = grads
            if work is not None and s + 1 == train["save_after"]:
                th = ckpt.save(work, s + 1, {"params": params, "opt": opt}, async_=True)
            if against_plain:
                lp, gp = loss_and_grads(before, net, prims, *batches[s], use_kernels=False)
                a, b = float(loss), float(lp)
                smoke.check(abs(a - b) <= LOSS_RTOL * abs(b) and math.isfinite(a),
                            f"train step {s + 1}: loss {a:.7f} (kernels) vs {b:.7f} (plain, "
                            f"same params), rtol {LOSS_RTOL}")
                label = f"train step {s + 1} gradients (kernels vs plain, same params)"
                if s == steps[0]:
                    _leaves_close(smoke, label, grads, gp)
                else:
                    print(f"{label}: max_abs_err / max|plain| by leaf " + ", ".join(
                        f"{float((g - w).abs().max()) / float(w.abs().max()):.2e}"
                        for g, w in zip(tree.leaves(grads), tree.leaves(gp))), flush=True)
                f64_worst.append(f64_gate(smoke, s + 1, before, net, *batches[s], grads, gp,
                                          gate=s != steps[0]))
                del lp, gp
        return params, opt, losses, grads0, host, dev_ms, th, peak

    steps = list(range(train["steps"]))
    with tempfile.TemporaryDirectory() as work:
        _free(device)
        kernels.reset_launch_counts()
        pk, ok_, lk, gk, host, dev_ms, th, peak = run(
            _clone(params0), init_state(params0, cfg), steps, None, work, against_plain=True)
        train_counts = kernels.launch_counts()
        th.join()
        for name, c in train_counts.items():
            counts[name] = counts.get(name, 0) + c
        per_step = {k: v // len(steps) for k, v in train_counts.items() if v}
        for s, (l, h, d) in enumerate(zip(lk, host, dev_ms)):
            print(f"train step {s + 1} (kernels): bce {float(l):.6f}, {h:.3f} ms host, "
                  f"{d:.3f} ms device", flush=True)
        print(f"train: kernel launches a step {json.dumps(per_step)}; allocator peak "
              f"{peak} B in the kernel run's steps", flush=True)
        for name in REACHED["train"]:
            smoke.check(train_counts.get(name, 0) > 0,
                        f"train: {name} launched {train_counts.get(name, 0)} times in "
                        f"{len(steps)} steps")

        _free(device)
        # the plain versions' own run from the same params: step 1 is the
        # same function at the same params; from step 2 on the two runs'
        # params differ (Adam moves a parameter whose gradient is near 0 by
        # about lr whichever its sign), so those steps are reported
        pp, op, lp, gp, host_p, dev_p, _, peak_p = run(_clone(params0), init_state(params0, cfg),
                                                       steps, False)
        print(f"train: plain run {[round(h, 3) for h in host_p]} ms host a step, "
              f"allocator peak {peak_p} B", flush=True)
        a, b = float(lk[0]), float(lp[0])
        smoke.check(abs(a - b) <= LOSS_RTOL * abs(b),
                    f"train step 1: loss {a:.7f} (kernels) vs {b:.7f} (the plain run), "
                    f"rtol {LOSS_RTOL}")
        grad_err = _leaves_close(smoke, "train step 1 gradients (kernels vs the plain run)",
                                 gk, gp)
        for s, (a, b) in enumerate(zip(lk, lp)):
            print(f"train step {s + 1}: loss {float(a):.7f} (kernel run) vs {float(b):.7f} "
                  f"(plain run), relative difference {abs(float(a) - float(b)) / abs(float(b)):.3e}",
                  flush=True)
        del pp, op, gp
        _free(device)

        # (c) resume from the checkpoint of step 3 into fresh objects
        fresh = convnet.init_params(net, torch.Generator().manual_seed(1), device=device)
        back = ckpt.restore(work, train["save_after"],
                            {"params": fresh, "opt": init_state(fresh, cfg)}, device=device)
        smoke.check(ckpt.latest_step(work) == train["save_after"],
                    f"train: checkpoint of step {train['save_after']} written (async)")
        pr, orr, lr_, _, _, _, _, _ = run(back["params"], back["opt"],
                                          steps[train["save_after"]:], None)
        same_loss = all(torch.equal(a, b) for a, b in zip(lr_, lk[train["save_after"]:]))
        same_p = all(torch.equal(a, b) for a, b in zip(tree.leaves(pr), tree.leaves(pk)))
        same_o = all(torch.equal(a, b) for a, b in zip(tree.leaves(orr), tree.leaves(ok_)))
        smoke.check(same_loss and same_p and same_o,
                    f"train resume: steps {train['save_after'] + 1}-{train['steps']} from the "
                    f"checkpoint bitwise equal to the uninterrupted run (losses {same_loss}, "
                    f"params {same_p}, optimizer state {same_o})")
        del pr, orr, back, fresh

    # one step with each low-precision moment state
    for dtype in ("bfloat16", "int8"):
        c = AdamWConfig(lr=train["lr"], state_dtype=dtype)
        p1, o1, l1, _ = train_step(_clone(params0), init_state(params0, c), net, prims,
                                   *batches[0], c)
        moved = max(float((a - b).abs().max())
                    for a, b in zip(tree.leaves(p1), tree.leaves(params0)))
        # Adam's first step moves a parameter by lr * (|m̂|/(sqrt(v̂)+eps) + wd |p|)
        limit = 1.01 * c.lr * (1 + c.weight_decay * max(
            float(t.abs().max()) for t in tree.leaves(params0)))
        kinds = {type(t).__name__ if isinstance(t, QTensor) else str(t.dtype)
                 for t in tree.leaves(o1["m"], is_leaf=lambda t: isinstance(t, QTensor))}
        smoke.check(torch.equal(l1, lk[0]) and moved <= limit and all(
            bool(torch.isfinite(t).all()) for t in tree.leaves(p1)),
                    f"train step 1 with {dtype} moments ({sorted(kinds)}): loss equal to the "
                    f"f32 run's, largest parameter move {moved:.3e} <= {limit:.3e}")
        del p1, o1

    # one step under the profiler: device time by kernel
    wall, busy, rows = device_profile(
        lambda: train_step(_clone(params0), init_state(params0, cfg), net, prims,
                           *batches[0], cfg),
        device, "one n337 training step (kernels)", top=16)
    return dict(losses=[float(v) for v in lk], plain_losses=[float(v) for v in lp],
                host_ms=host, device_ms=dev_ms, plain_host_ms=host_p, plain_device_ms=dev_p,
                launches_per_step=per_step, allocator_peak=peak, plain_allocator_peak=peak_p,
                saved_bytes=saved,
                step1_grad_max_abs_err=grad_err, f64_err_over_tol=f64_worst,
                profiled_wall_ms=wall * 1e3,
                profiled_busy_ms=busy * 1e3)


def run_examples(smoke, device, seg_steps=TRAIN["seg_steps"]):
    """Phase 7d–e: the seg-net example's 200 steps, then quickstart,
    serve_volume and pipeline_inference (its two ranks), on the card."""
    import numpy as np

    from repro_torch.examples import pipeline_inference, quickstart, serve_volume
    from repro_torch.examples import train_segmentation

    t = time.perf_counter()
    losses = train_segmentation.train(seg_steps, 1e-3, device,
                                      log=lambda s: print(f"seg-net: {s}", flush=True))
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    smoke.check(last < first, f"seg-net: {seg_steps} steps in "
                              f"{time.perf_counter() - t:.1f} s, first-10 mean {first:.4f} -> "
                              f"last-10 mean {last:.4f}")
    argv = [] if device.type == "cuda" else ["--device", str(device)]
    for name, fn in (("quickstart", lambda: quickstart.main(argv)),
                     ("serve_volume", lambda: serve_volume.main(argv)),
                     ("pipeline_inference", lambda: pipeline_inference.main(argv))):
        t = time.perf_counter()
        try:
            fn()
            ok, why = True, ""
        except (Exception, SystemExit) as exc:  # recorded as a failed check
            traceback.print_exc()
            ok, why = False, f": {type(exc).__name__}: {exc}"
        smoke.check(ok, f"example {name} on the card: {time.perf_counter() - t:.1f} s{why}")
    return dict(seg_first10=first, seg_last10=last, seg_losses=losses[::25])


def run_train(device, net, seed=0, *, train=TRAIN, **shapes):
    """Phase 7: returns (kernel results, launch counts, failures).
    ``shapes`` overrides ``check_grad_kernels``'s shape lists (a CPU
    rehearsal passes small ones with a narrow net)."""
    import torch

    smoke = Smoke()
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    t = time.perf_counter()
    results = check_grad_kernels(smoke, device, gen, **shapes)
    print(f"train: gradient kernels checked in {time.perf_counter() - t:.1f} s", flush=True)
    counts = {}
    t = time.perf_counter()
    stats = train_n337(smoke, device, net, counts, train)
    print(f"train: n337 phase {time.perf_counter() - t:.1f} s", flush=True)
    _free(device)
    t = time.perf_counter()
    stats.update(run_examples(smoke, device, train["seg_steps"]))
    print(f"train: examples {time.perf_counter() - t:.1f} s", flush=True)
    print("training: " + json.dumps(stats), flush=True)
    return results, counts, smoke.failures


def run(device, net, m: int, batch: int, hw, seed: int = 0, *, dense_m: int,
        plain_net, dense_prims=None):
    """All phases after the build; returns (kernel results, failures)."""
    import numpy as np
    import torch

    from repro_torch.core import convnet, planner

    smoke = Smoke()
    gen = torch.Generator().manual_seed(seed)
    params = convnet.init_params(net, gen, device=device)
    # nonzero biases, so the DC-bin bias epilogues carry real values
    params = [None if p is None else (p[0], 0.1 * torch.randn(
        p[1].shape, generator=gen).to(device)) for p in params]
    prims = ["overlap_save" if i == 0 else ("fft_cached" if l.kind == "conv" else "mpf")
             for i, l in enumerate(net.layers)]
    fov = net.field_of_view()
    core = m * net.total_pooling()
    shapes = request_shapes(core, fov)
    plan = planner.plan_fixed(net, hw, prims, m=m, batch=batch, volume_shape=shapes[0])
    if plan is None:
        smoke.check(False, "plan_fixed found the served configuration infeasible")
        return {}, smoke.failures
    print(f"plan: {net.name} core {plan.core} n_in {plan.n_in} batch {plan.batch} "
          f"sweep_axis {plan.sweep_axis} prims {plan.prims}", flush=True)
    rng = np.random.default_rng(seed)
    vols = [rng.normal(size=(net.in_channels,) + s).astype(np.float32) for s in shapes]
    dense = [
        convnet.apply_dense_reference(
            params, net, torch.from_numpy(v)[None].to(device))[0].cpu()
        for v in vols
    ]
    _sync(device)

    from repro_torch.serving import VolumeEngine

    engine = VolumeEngine(params, net, plan, fuse_os=False, tuned=None, device=device)
    results = check_kernels(smoke, engine.executor, plan, device, gen)
    check_ragged(smoke, device, gen)
    launches = {name: 0 for name in KERNELS}
    serving = {}
    for fuse_os in (False, True):
        label = f"fuse_os={fuse_os}"
        engine, counts, serving[label] = serve(
            smoke, label, REACHED[fuse_os], net, plan, params, vols, dense, device,
            engine=engine if not fuse_os else None, fuse_os=fuse_os, tuned=None,
        )
        smoke.check(engine.executor.fuse_os == fuse_os, f"{label}: executor mode")
        for name in launches:
            launches[name] += counts[name]
        if not fuse_os:
            del engine
            if device.type == "cuda":
                torch.cuda.empty_cache()
    profile_tick(engine, vols[0], device)
    offline(smoke, engine.executor, vols[0], dense[0], device)
    del engine
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    streamed, vol, want = run_streamed(smoke, device, net, plan, params, vols, dense,
                                       launches, seed)
    serving.update(streamed)
    print(f"streamed phase: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    serving.update(run_axes_fleet(smoke, device, net, plan, params, vol, want, launches))
    print(f"axes and fleet phase: {time.perf_counter() - t:.1f} s", flush=True)
    del vol, want
    _free(device)
    t = time.perf_counter()
    serving.update(run_tuned(smoke, device, net, plan, params, vols, dense, launches,
                             serving, seed))
    print(f"tuned phase: {time.perf_counter() - t:.1f} s", flush=True)
    del dense
    _free(device)
    if device.type == "cuda":
        print(f"allocated after the reuse phases: {torch.cuda.memory_allocated(device)} B",
              flush=True)

    results.update(run_dense(smoke, device, net, params, hw, dense_m, batch,
                             launches, serving, gen, prims=dense_prims))
    plain_pool(smoke, device, plain_net, hw, seed)
    for name, r in results.items():
        r["launches"] = launches[name]
    print("serving: " + json.dumps(serving), flush=True)
    return results, smoke.failures


def main() -> int:
    if len(sys.argv) > 1:
        # one rank of the distributed phase, started by run_distributed
        import argparse

        ap = argparse.ArgumentParser()
        for flag in ("--rank", "--world", "--port"):
            ap.add_argument(flag, type=int, required=True)
        ap.add_argument("--dir", required=True)
        args = ap.parse_args()
        return rank_main(args.rank, args.world, args.port, args.dir)
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from the repository root (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from repro_torch.configs import get_config
    from repro_torch.configs.znni_nets import BENCH_NET, N337
    from repro_torch.core.hw import H100_SXM
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attn.ops import CHUNK

    t = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t:.1f} s", flush=True)
    names = ("cmul_mad_kernel", "axis_product", "short_axis", "rows_gemm",
             "mpf_pool_kernel", "conv3d_plane", "conv3d_column", "decode_attn_chunk",
             "decode_attn_combine", "conv3d_wgrad", "mpf_pool_bwd")
    for entry, usage in build.ptxas_usage(names):
        # from the kernel's name on: its template arguments, mangled
        name = entry[min(entry.find(n) for n in names if n in entry):]
        print(f"ptxas: {name[:48]}: {usage}", flush=True)

    device = torch.device("cuda", 0)
    results, failures = run(device, N337, m=4, batch=2, hw=H100_SXM, dense_m=8,
                            plain_net=BENCH_NET)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    znni_serving, znni_counts, znni_failures = run_znni_nets(device, H100_SXM)
    failures += znni_failures
    for name in KERNELS:
        r = results.setdefault(name, {})
        r["launches"] = r.get("launches", 0) + znni_counts.get(name, 0)
    print("serving znni nets: " + json.dumps(znni_serving), flush=True)
    print(f"znni nets phase: {time.perf_counter() - t:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    train_results, train_counts, train_failures = run_train(device, N337)
    failures += train_failures
    for name in KERNELS:
        r = results.setdefault(name, {})
        r.update(train_results.get(name, {}))
        r["launches"] = r.get("launches", 0) + train_counts.get(name, 0)
    print(f"train phase: {time.perf_counter() - t:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    results["decode_attn"], lm_failures = run_lm(
        device, get_config("qwen2.5-14b"),
        da_cases=[("served", 8, 2048, 8, 5, 128, "bfloat16"),
                  ("f32", 4, 1024, 8, 5, 128, "float32"),
                  ("ragged", 3, 600, 8, 5, 128, "bfloat16"),
                  # one long sequence, where the split over S matters most
                  ("single", 1, 2048, 8, 5, 128, "bfloat16", [2048]),
                  # ends on, just past and just before a chunk boundary,
                  # one row, and past S
                  ("chunk ends", 5, 600, 8, 5, 128, "bfloat16",
                   [CHUNK, 2 * CHUNK + 1, 2 * CHUNK - 1, 1, 605]),
                  ("chunk ends f32", 3, 300, 4, 8, 64, "float32",
                   [CHUNK, CHUNK + 1, 305]),
                  # two 8-head blocks on the tensor cores, d no multiple of 16
                  ("G 12, d 40", 2, 300, 2, 12, 40, "bfloat16", [300, CHUNK + 1])],
        slots=8, max_seq=2048, n_requests=12, prompt_range=(64, 1537),
        new_range=(16, 65))
    failures += lm_failures
    torch.cuda.empty_cache()
    arch_stats, arch_launches, arch_failures = run_lm_archs(device)
    failures += arch_failures
    results["decode_attn"]["launches"] += arch_launches
    print(f"lm phase: {time.perf_counter() - t:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    vlm_cfg, cuts = lm_arch_config("qwen2-vl-7b", torch.cuda.get_device_properties(device)
                                   .total_memory, slots=LM_ARCH_GRID["slots"],
                                   max_seq=LM_ARCH_GRID["max_seq"])
    print(f"lm qwen2-vl-7b: cuts: {cuts}; {vlm_cfg.param_count()} parameters", flush=True)
    _, fe_launches, fe_failures = run_lm_frontends(
        device, vlm_cfg, get_config("whisper-tiny"),
        da_cases=[("qwen2-vl-7b, served", 4, 512, 4, 7, 128, "bfloat16"),
                  # whisper's decoder: lengths across the split's chunk
                  # boundary, a full cache and one past it
                  ("whisper-tiny, decoder", 4, 448, 6, 1, 64, "bfloat16",
                   [CHUNK - 1, CHUNK + 1, 448, 453])],
        grid=LM_ARCH_GRID, card=card)
    failures += fe_failures
    results["decode_attn"]["launches"] += fe_launches
    print(f"lm frontends phase: {time.perf_counter() - t:.1f} s", flush=True)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": r.get("launches"), "max_abs_err": r.get("max_abs_err"),
            "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
            "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
            "library_ms": r.get("library_ms"),
        })
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", file=sys.stderr)
        for f in failures:
            print("  " + f, file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
