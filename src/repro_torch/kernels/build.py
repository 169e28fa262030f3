"""Build the port's CUDA kernels at first use and bind them through ctypes.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` — one
``nvcc`` process per source, all started together — and the objects link
into one shared library with a plain C interface.  The library lands in
``csrc/build/<hash>/``, keyed by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads at once.  Nothing here
runs at import time: ``library()`` builds on its first call.

Every C entry point that launches returns ``cudaGetLastError()`` after
its launches; ``check`` raises when that is not 0.  (``conv3d_wgrad_chunks``
launches nothing: it returns the scratch size its launch will need.)
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# ptxas's report of each kernel's registers, shared memory and spills,
# kept beside the library
PTXAS_LOG = "ptxas.log"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C signatures: every function returns an int (a cudaError_t, but for
# conv3d_wgrad_chunks)
SIGNATURES = {
    # X, W, nb (nullable), O, S, f, fp, B, stream
    "cmul_mad_c64": (_P, _P, _P, _P, _I, _I, _I, _L, _P),
    # x, out, S, f, nx, ny, nz, p, mx, my, mz, stream
    "mpf_pool_f32": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # F, W, nb, Z, P, T, Y1, Y2, out, N, Q, f, fp, A, B, Cb, C, s, oy, oz,
    # j0, out0, L, RS, logT, RC, stream
    "os_segment_f32": (_P,) * 9 + (_I,) * 17 + (_P,),
    # x, fz, fy, fx, W, nb, P, T, bufA, bufB, bufC, out, N, Q, f, fp, E,
    # seg, nx, ny, nz, A, B, Cb, C, s, oy, oz, out0, mad, RS, logT, RC,
    # stream
    "os_segment_conv_f32": (_P,) * 12 + (_I,) * 21 + (_P,),
    # x, w, out, S, f, fp, nx, ny, nz, kx, ky, kz, stream
    "conv3d_f32": (_P,) * 3 + (_I,) * 9 + (_P,),
    # S, f, fp, nx, ny, nz, kx, ky, kz (returns the chunks C, or -1)
    "conv3d_wgrad_chunks": (_I,) * 9,
    # x, g, part, dw, S, f, fp, nx, ny, nz, kx, ky, kz, C, stream
    "conv3d_wgrad_f32": (_P,) * 4 + (_I,) * 10 + (_P,),
    # x, gy, gx, S, f, nx, ny, nz, p, mx, my, mz, stream
    "mpf_pool_bwd_f32": (_P,) * 3 + (_I,) * 9 + (_P,),
    # q, k, v, lengths, part, out, B, S, Hkv, G, d, chunk, stream
    "decode_attn_f32": (_P,) * 6 + (_I,) * 6 + (_P,),
    "decode_attn_bf16": (_P,) * 6 + (_I,) * 6 + (_P,),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    """Compile every .cu in parallel, link, and move the library into place
    atomically (concurrent builders each use their own scratch dir)."""
    nvcc = _nvcc()
    tmp = out.parent / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    errors, logs = [], []
    for src, _, proc in procs:
        log, _ = proc.communicate()
        logs.append(log)
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    (out.parent / PTXAS_LOG).write_text("".join(logs))
    lib = tmp / LIB_NAME
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib)] + [
        str(obj) for _, obj, _ in procs
    ]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    os.replace(lib, out)
    shutil.rmtree(tmp, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    out = BUILD_DIR / _digest() / LIB_NAME
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        _build(out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def ptxas_usage(names) -> list:
    """(kernel, ptxas's usage line) for each compiled kernel whose mangled
    name contains one of ``names``, from the last build's log."""
    path = BUILD_DIR / _digest() / PTXAS_LOG
    return parse_ptxas(path.read_text() if path.exists() else "", names)


def parse_ptxas(log: str, names) -> list:
    """(kernel, usage line and spills) for each kernel in an ``-Xptxas=-v``
    log whose mangled name contains one of ``names``."""
    rows, entry, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry, spills = line.split("'")[1], ""
        elif "spill stores" in line:
            spills = "; " + line.strip()
        elif "Used" in line and entry is not None:
            if any(n in entry for n in names):
                rows.append((entry, line.split(":", 1)[-1].strip() + spills))
            entry = None
    return rows


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on the tensor's device, as an int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
