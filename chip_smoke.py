#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card; without one (or without the repository's
``src/repro_torch`` beside it) it exits non-zero and prints no result.

Phases, in order; any failure makes the exit code non-zero:

1. Print the card's name and power limit (``nvidia-smi``), then build the
   CUDA kernels from ``src/repro_torch/csrc`` and print the build time.
2. Hold each CUDA kernel against its plain PyTorch version on the card,
   at the shapes the served n337 plan gives it (read off the compiled
   plan), with the tolerance printed beside it; time kernel, plain version
   and, where one PyTorch call computes the same function, that call.
3. Serve full-width n337 (Table III: 80 maps, 10 layers; random weights
   from a seed) through ``VolumeEngine`` on an ``H100_SXM`` plan with the
   deployed primitives (``overlap_save`` at layer 0, ``fft_cached`` deeper,
   ``mpf`` pools, deep reuse on), three requests of different sizes, with
   ``fuse_os`` off and then on.  Every kernel's launch count is zeroed just
   before each run and read just after; outputs are held against the dense
   oracle (``apply_dense_reference``, TF32 off).  The largest request is
   swept once more offline (``PlanExecutor.run``) and its counters held
   against ``predict_counts``.
4. Print the kernels' JSON line, then, as the last line,
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
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
}
# kernels each serving mode must launch (cmul_mad_bias only serves the
# fused conv+pool pairs of fuse_os)
REACHED = {
    False: ("os_segment", "cmul_mad", "mpf_pool"),
    True: ("os_segment", "cmul_mad", "cmul_mad_bias", "mpf_pool"),
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
    """Mean milliseconds per call: CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    _sync(device)
    if device.type != "cuda":
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and operations over the fp32 rate, and which of the two it is."""
    tb, tf = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def _nb(t) -> float:
    return float(t.numel() * t.element_size())


def _close(got, want, atol, rtol):
    import torch

    err = (got - want).abs()
    ok = bool(torch.all(err <= atol + rtol * want.abs()))
    return ok, float(err.max())


def check_kernels(smoke, ex, plan, device, gen):
    """Phase 2: every kernel vs its plain version at the plan's shapes."""
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
    r["ms"] = time_ms(lambda: seg_ops.os_segment_fused(F, W0, b0, spec), device)
    r["plain_ms"] = time_ms(
        lambda: seg_ops.os_segment_fused(F, W0, b0, spec, use_kernels=False),
        device, reps=2)
    r["bound_ms"], r["bound_by"] = bound(nbytes, flops)
    r["library_ms"] = None
    print(f"os_segment: the kernel's own matmul-DFT inverse is {dft_flops / 1e9:.1f} "
          f"GFLOP ({dft_flops / PEAK_FP32 * 1e3:.3f} ms at the fp32 peak); the "
          f"function needs {flops / 1e9:.1f} GFLOP and {nbytes / 1e9:.3f} GB", flush=True)

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
        # flat bin 0 carries the DC bias (b*prod(fft_shape)), far above the
        # other bins: each part gets an atol scaled from its own magnitude
        g, w = got.reshape(-1, bins), want.reshape(-1, bins)
        atol_dc = 1e-4 * float(w[:, 0].abs().max())
        atol = 1e-4 * float(w[:, 1:].abs().max())
        ok_dc, err_dc = _close(g[:, 0], w[:, 0], atol=atol_dc, rtol=1e-4)
        ok, err = _close(g[:, 1:], w[:, 1:], atol=atol, rtol=1e-4)
        smoke.check(ok and ok_dc,
                    f"{name} vs plain, X {tuple(X2.shape)} W {tuple(W2.shape)}: "
                    f"max_abs_err {err:.3e} off bin 0 (atol 1e-4*max|plain| there = "
                    f"{atol:.3e}), {err_dc:.3e} at bin 0 (atol {atol_dc:.3e}); rtol 1e-4")
        err = max(err, err_dc)
        nbytes = _nb(X2) + _nb(W2) + S2 * fp2 * bins * 8.0
        if name == "cmul_mad_bias":
            nbytes += _nb(b2)
        r = dict(max_abs_err=err)
        r["ms"] = time_ms(lambda: call(None), device)
        r["plain_ms"] = time_ms(lambda: call(False), device, reps=2)
        r["bound_ms"], r["bound_by"] = bound(nbytes, 8.0 * S2 * f2 * fp2 * bins)
        r["library_ms"] = (
            time_ms(lambda: torch.einsum("si...,ji...->sj...", X2, W2), device)
            if name == "cmul_mad" else None
        )
        results[name] = r
        del got, want

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
    r = dict(max_abs_err=err)
    r["ms"] = time_ms(lambda: mpf_ops.mpf_pool(x1, p), device)
    r["plain_ms"] = time_ms(lambda: mpf_ops.mpf_pool(x1, p, use_kernels=False),
                            device, reps=2)
    r["bound_ms"], r["bound_by"] = bound(_nb(x1) + _nb(got), float(got.numel()) * (p**3 - 1))
    r["library_ms"] = None
    results["mpf_pool"] = r
    for name, r in results.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        print(f"kernel {name}: {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"library {lib} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})",
              flush=True)
    print("kernels: " + json.dumps(sorted(results)), flush=True)
    return results


def request_shapes(core: int, fov: int):
    """Three requests shaped like the benchmark's volume: the largest has
    three cores and a non-core-aligned remainder on x; one is a single
    patch, which drains mid-batch so its tick mixes two requests."""
    return [
        (3 * core + 3 + fov - 1, 2 * core + fov - 1, 2 * core + fov - 1),
        (core + fov - 1,) * 3,
        (2 * core + fov - 1, core + fov - 1, 2 * core + fov - 1),
    ]


def serve(smoke, net, plan, params, vols, dense, device, fuse_os, engine=None):
    """Phase 3 for one mode: drive VolumeEngine with counts zeroed just
    before and read just after; hold outputs against the dense oracle."""
    import torch

    from repro_torch import kernels
    from repro_torch.serving import VolumeEngine, VolumeRequest

    if engine is None:
        engine = VolumeEngine(params, net, plan, fuse_os=fuse_os, device=device)
    reqs = [VolumeRequest(i, v) for i, v in enumerate(vols)]
    for r in reqs:
        engine.submit(r)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    engine.run_until_drained()
    _sync(device)
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    ex = engine.executor
    vox = sum(float(math.prod(r.out.shape[1:])) for r in reqs)
    mixed = any(k[0] == "oswalk" for k in ex._trace_keys)
    peak_alloc = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"serve fuse_os={fuse_os}: {len(reqs)} requests, {engine.ticks} ticks, "
          f"{vox:.0f} voxels in {dt:.3f} s = {vox / dt:.1f} vox/s; "
          f"peak_device_bytes (ledger) {ex.last_stats['peak_device_bytes']:.0f}, "
          f"max_memory_allocated {peak_alloc}; retraces {ex.last_stats['retraces']}; "
          f"launches {json.dumps(counts)}", flush=True)
    smoke.check(all(r.done for r in reqs), f"fuse_os={fuse_os}: every request done")
    smoke.check(mixed, f"fuse_os={fuse_os}: a tick mixed two requests")
    smoke.check(ex.fuse_os == fuse_os, f"fuse_os={fuse_os}: executor mode")
    for name in REACHED[fuse_os]:
        smoke.check(counts[name] > 0, f"fuse_os={fuse_os}: {name} launched "
                                      f"{counts[name]} times on the main path")
    for r, want in zip(reqs, dense):
        got = torch.from_numpy(r.out)
        ok, err = _close(got, want, **E2E)
        smoke.check(ok and bool(torch.isfinite(got).all()),
                    f"fuse_os={fuse_os}: request {r.rid} {tuple(r.out.shape)} vs "
                    f"dense oracle: max_abs_err {err:.3e} (atol {E2E['atol']}, "
                    f"rtol {E2E['rtol']}, max|ref| {float(want.abs().max()):.3f})")
    return engine, counts, dict(seconds=dt, voxps=vox / dt, voxels=vox)


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


def run(device, net, m: int, batch: int, hw, seed: int = 0):
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

    engine = VolumeEngine(params, net, plan, fuse_os=False, device=device)
    results = check_kernels(smoke, engine.executor, plan, device, gen)
    launches = {name: 0 for name in KERNELS}
    serving = {}
    for fuse_os in (False, True):
        engine, counts, serving[fuse_os] = serve(
            smoke, net, plan, params, vols, dense, device, fuse_os,
            engine=engine if not fuse_os else None,
        )
        for name in launches:
            launches[name] += counts[name]
        if not fuse_os:
            del engine
            if device.type == "cuda":
                torch.cuda.empty_cache()
    offline(smoke, engine.executor, vols[0], dense[0], device)
    for name, r in results.items():
        r["launches"] = launches[name]
    print("serving: " + json.dumps({f"fuse_os={k}": v for k, v in serving.items()}),
          flush=True)
    return results, smoke.failures


def main() -> int:
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

    from repro_torch.configs.znni_nets import N337
    from repro_torch.core.hw import H100_SXM
    from repro_torch.kernels import build

    t = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t:.1f} s", flush=True)

    device = torch.device("cuda", 0)
    results, failures = run(device, N337, m=4, batch=2, hw=H100_SXM)
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
