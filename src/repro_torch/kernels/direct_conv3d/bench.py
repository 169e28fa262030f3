"""Time the direct conv's CUDA kernel against other versions of its source.

    PYTHONPATH=src python3 -m repro_torch.kernels.direct_conv3d.bench \
        [--against OTHER.cu ...] [--reps N]

Builds ``csrc/direct_conv3d.cu`` and each ``--against`` file (any source
with the same ``conv3d_f32`` C entry, e.g. an earlier commit's) into a
library of its own, holds each against the plain version at n337's two
dense-path call sites within ``atol=1e-3, rtol=1e-4``, and times them in
turns on one card (A, B, ..., B, A), beside cuDNN's ``conv3d`` without a
bias and in full fp32 (a yardstick only), and the bound.  Prints the
card, ptxas's registers and spills of each build's kernels, one line a
version and shape, and a JSON summary as the last line.  Needs a CUDA
card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .. import build
from . import ref

# n337's direct layers on the dense path at m = 8, batch 2 (the shapes
# chip_smoke.py's dense phase reads off the planner's plan)
CALL_SITES = {
    "layer 0": ((2, 1, 148, 148, 148), (80, 1, 2, 2, 2)),
    "layer 9": ((1024, 80, 10, 10, 10), (3, 80, 3, 3, 3)),
}
E2E = dict(atol=1e-3, rtol=1e-4)
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12  # NVIDIA H100 SXM data sheet


def _compile(src: Path, out_dir: Path):
    """nvcc src into out_dir/lib.so with the port's flags; returns
    (library, ptxas log)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "lib.so"
    res = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    return lib, res.stdout + res.stderr


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    fn = lib.conv3d_f32
    fn.argtypes = list(build.SIGNATURES["conv3d_f32"])
    fn.restype = ctypes.c_int
    return fn


def _launcher(fn):
    def run(x, w):
        n, k = x.shape[2:], w.shape[2:]
        out = torch.empty((x.shape[0], w.shape[0]) + tuple(a - b + 1 for a, b in zip(n, k)),
                          dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                 w.shape[0], *n, *k, build.stream_of(x))
        if err != 0:
            raise RuntimeError(f"conv3d_f32: CUDA error {err}")
        return out
    return run


def time_ms(fn, reps: int) -> float:
    """Mean ms a call over ``reps`` calls, CUDA events, queued behind a
    ~10 ms spin of the card so the card, not the host, sets the pace."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[], type=Path,
                    help="other direct_conv3d.cu sources to time beside this tree's")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(f"card: {card}", flush=True)
    sources = [("tree", build.CSRC / "direct_conv3d.cu")] + [
        (str(p), p.resolve()) for p in args.against]
    t = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(lambda s: _compile(s[1], build.BUILD_DIR / "bench" / hashlib.sha256(
            s[1].read_bytes()).hexdigest()[:16]), sources))
    print(f"build: {time.perf_counter() - t:.1f} s", flush=True)
    runs = {}
    for (label, _), (lib, log) in zip(sources, built):
        runs[label] = _launcher(_bind(lib))
        for entry, usage in build.parse_ptxas(log, ("conv3d_",)):
            print(f"ptxas [{label}]: {entry[entry.find('conv3d_'):][:40]}: {usage}",
                  flush=True)

    gen = torch.Generator().manual_seed(0)
    summary, ok_all = {"card": card}, True
    dev = torch.device("cuda", 0)
    for site, (xs, ws) in CALL_SITES.items():
        x = torch.randn(xs, generator=gen).to(dev)
        w = (torch.randn(ws, generator=gen) / math.sqrt(math.prod(ws[1:]))).to(dev)
        want = ref.conv3d(x, w)
        for label, run in runs.items():
            err = (run(x, w) - want).abs()
            ok = bool((err <= E2E["atol"] + E2E["rtol"] * want.abs()).all())
            ok_all &= ok
            print(f"{'ok  ' if ok else 'FAIL'} {site} [{label}] vs plain: max_abs_err "
                  f"{float(err.max()):.3e} (atol {E2E['atol']}, rtol {E2E['rtol']})",
                  flush=True)
        del err
        order = list(runs) + list(reversed(runs))
        times = {label: [] for label in runs}
        for label in order:
            times[label].append(time_ms(lambda: runs[label](x, w), args.reps))

        def cudnn():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return torch.nn.functional.conv3d(x, w)
        lib_ms = time_ms(cudnn, args.reps)
        # the card's write rate: one fill of a tensor of the output's size
        fill_ms = time_ms(lambda: want.fill_(0.0), args.reps)
        nbytes = 4.0 * (x.numel() + w.numel() + want.numel())
        flops = 2.0 * want.numel() * math.prod(ws[1:])
        tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
        bound_ms, by = max(tb, tf), "bytes" if tb >= tf else "operations"
        row = {"cudnn_ms": lib_ms, "fill_ms": fill_ms, "bound_ms": bound_ms, "bound_by": by}
        for label, ts in times.items():
            ms = sum(ts) / len(ts)
            row[label] = {"ms": ms, "runs": ts}
            print(f"{site} [{label}]: {ms:.4f} ms (runs {', '.join(f'{v:.4f}' for v in ts)}), "
                  f"{100 * bound_ms / ms:.1f}% of the bound", flush=True)
        print(f"{site}: x {xs} w {ws}: cuDNN conv3d (no bias, fp32) {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}); fill_ of the output's {4 * want.numel() / 1e9:.3f} "
              f"GB {fill_ms:.4f} ms", flush=True)
        summary[site] = row
        del x, w, want
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
