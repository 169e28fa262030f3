"""The dry run on ``meta`` tensors: for each (architecture × input shape ×
mesh) cell, what a device holds and which roofline term dominates.

The reference lowers and compiles every cell with ShapeDtypeStruct
inputs on a 512-device CPU platform and reads XLA's memory and cost
analysis.  The port runs the cell's step once on ``meta`` tensors, which
allocates nothing, and counts it (``roofline.analysis.count_step``):
``FlopCounterMode``'s FLOPs, the unfused bytes eager PyTorch moves, and
the peak of live bytes.  The step is the reference's: train cells run
the whole ``make_train_step`` (forward, backward and AdamW at the
reference's ``state_dtype`` rule), prefill cells ``Model.prefill`` and
decode cells ``Model.decode_step``; on ``meta`` every kernel takes its
plain route (``kernels/dispatch.py``).

Per device, on the production mesh (256 or 512 H100s):
  * argument bytes are exact: each parameter, optimizer-state and input
    leaf's ``shard_shape`` under the sharding rules, times its itemsize;
  * temp bytes are an estimate, the meta peak less the arguments divided
    by the devices that shard the batch (``temp_basis``), where the
    reference reads XLA's post-partition figure;
  * FLOPs and bytes are the global step's over the devices (``cost_basis``);
  * collectives are not counted (``None``): no compiler inserts them, and
    the reference's ``collective_bytes`` reads XLA's HLO.  The roofline's
    collective term is then 0.
The compute term is priced at the peak of the cell's dtype (989 TFLOP/s
bf16 on the tensor cores; ``H100_SXM.peak_flops``, fp32, otherwise), and
``fits_hbm`` is judged against the card's 80 GB.  One meta run serves
both meshes: they run the same global step and only the division differs.

Run on the CPU (artifacts under ``experiments/dryrun_torch/``, named
``{tag}__{arch}__{shape}__{mesh}.json`` as the reference names them):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --probe
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..configs import ARCHS, SHAPES, cell_applicable, get_config, get_shape
from ..configs.base import ModelConfig, ShapeConfig
from ..core.hw import H100_SXM
from ..distributed.sharding import (
    _batch_axes, batch_shardings, param_shardings, replicated, shard_shape,
)
from ..models import build_model
from ..optim import AdamWConfig, init_state, tree
from ..roofline.analysis import StepCounts, count_step, roofline
from .mesh import Mesh, make_production_mesh
from .train import make_train_step

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                           "dryrun_torch")

# the compute term's peak by the cell's dtype: dense bf16 on the tensor
# cores (NVIDIA's H100 SXM data sheet), fp32 outside them
PEAK_FLOPS = {"bfloat16": (989e12, "bf16 tensor cores"),
              "float16": (989e12, "fp16 tensor cores"),
              "float32": (H100_SXM.peak_flops, "fp32")}
TEMP_BASIS = "meta peak / batch shards"
COST_BASIS = "global meta count / devices; bytes are the unfused aten traffic"
COLLECTIVES_NOTE = ("not counted: the port has no compiler that inserts collectives, "
                    "and collective_bytes reads XLA's HLO")


def _model_flops(cfg, shape) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def _apply_overrides(cfg, overrides: Dict[str, Any]):
    """Config-level hillclimb levers."""
    if overrides.get("pad_q_groups") and cfg.attn is not None:
        cfg = dataclasses.replace(
            cfg, attn=dataclasses.replace(cfg.attn, pad_q_groups=overrides["pad_q_groups"])
        )
    if overrides.get("expand_kv") and cfg.attn is not None:
        cfg = dataclasses.replace(
            cfg, attn=dataclasses.replace(cfg.attn, expand_kv=True)
        )
    if overrides.get("dtype"):
        cfg = dataclasses.replace(cfg, dtype=overrides["dtype"])
    if overrides.get("moe_routing_groups"):
        cfg = dataclasses.replace(cfg, moe_routing_groups=overrides["moe_routing_groups"])
    if overrides.get("decode_replicate_activations"):
        cfg = dataclasses.replace(cfg, decode_replicate_activations=True)
    return cfg


@dataclasses.dataclass
class Measured:
    """One cell's step counted on meta: its trees (shapes only) and counts."""

    cfg: ModelConfig
    shape: ShapeConfig
    params: Any
    opt_state: Optional[Dict[str, Any]]
    specs: Dict[str, Any]
    counts: StepCounts
    seconds: float


def _state_dtype(cfg: ModelConfig, overrides: Dict[str, Any]) -> str:
    return overrides.get("opt_state_dtype",
                         "bfloat16" if cfg.param_count() > 40e9 else "float32")


def _trees(cfg: ModelConfig, shape: ShapeConfig, overrides: Dict[str, Any]):
    """The step's meta arguments: params, optimizer state (train) and inputs."""
    model = build_model(cfg)
    params = model.init(torch.Generator(), device="meta")
    opt = (init_state(params, AdamWConfig(state_dtype=_state_dtype(cfg, overrides)))
           if shape.kind == "train" else None)
    return model, params, opt, model.input_specs(shape)


def _measure_cell(cfg: ModelConfig, shape: ShapeConfig,
                  overrides: Dict[str, Any]) -> Measured:
    """Run the cell's global step once on meta and count it (the reference's
    ``_compile_cell``, with the compile replaced by a meta run)."""
    cfg = _apply_overrides(cfg, overrides)
    t0 = time.monotonic()
    model, params, opt, specs = _trees(cfg, shape, overrides)
    if shape.kind == "train":
        ocfg = AdamWConfig(state_dtype=_state_dtype(cfg, overrides))
        step = make_train_step(model, ocfg, remat=overrides.get("remat", True))
        counts = count_step(step, params, opt, specs)
    elif shape.kind == "prefill":
        counts = count_step(
            lambda p, batch: model.prefill(p, batch, cache_len=shape.seq_len), params, specs)
    else:
        counts = count_step(lambda p, tokens, caches: model.decode_step(p, tokens, caches),
                            params, specs["tokens"], specs["caches"])
    return Measured(cfg, shape, params, opt, specs, counts, time.monotonic() - t0)


def _lin(v1: float, v2: float, reps_full: float) -> float:
    # the quantity cannot shrink with depth: clamp at the probes
    return max(v1 + (reps_full - 1.0) * (v2 - v1), v1, v2)


def _probe_cell(cfg: ModelConfig, shape: ShapeConfig,
                overrides: Dict[str, Any]) -> Measured:
    """The cell at 1× and 2× its block pattern, extrapolated linearly to its
    depth: FLOPs, bytes, outputs and temp bytes; the arguments are the
    full-depth trees' (exact)."""
    PL = len(cfg.block_pattern)

    def probe_cfg(reps: int):
        kw: Dict[str, Any] = {"n_layers": PL * reps}
        if cfg.enc_dec:
            kw["n_enc_layers"] = reps
        return dataclasses.replace(cfg, **kw)

    t0 = time.monotonic()
    c1, c2 = (_measure_cell(probe_cfg(r), shape, overrides).counts for r in (1, 2))
    full = _apply_overrides(cfg, overrides)
    _, params, opt, specs = _trees(full, shape, overrides)
    reps_full = cfg.n_layers / PL
    arg_bytes = storage_bytes((params, opt, specs))
    temp = _lin(c1.peak_bytes - c1.arg_bytes, c2.peak_bytes - c2.arg_bytes, reps_full)
    counts = StepCounts(
        flops=round(_lin(c1.flops, c2.flops, reps_full)),
        bytes_accessed=round(_lin(c1.bytes_accessed, c2.bytes_accessed, reps_full)),
        arg_bytes=arg_bytes, peak_bytes=arg_bytes + round(temp),
        out_bytes=round(_lin(c1.out_bytes, c2.out_bytes, reps_full)))
    return Measured(full, shape, params, opt, specs, counts, time.monotonic() - t0)


def storage_bytes(tree_: Any) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    return sum({st._cdata: st.nbytes() for st in (t.untyped_storage()
                                                    for t in tree.leaves(tree_))}.values())


def _sharded_bytes(tree_: Any, shardings: Any) -> int:
    """Exact bytes one device holds of ``tree_`` under ``shardings``."""
    return sum(math.prod(shard_shape(tuple(t.shape), s)) * t.element_size()
               for t, s in zip(tree.leaves(tree_), tree.leaves(shardings)))


def _mesh(mesh_kind: str) -> Mesh:
    return make_production_mesh(multi_pod=(mesh_kind == "multi"))


def batch_shards(shape: ShapeConfig, mesh: Mesh) -> int:
    """The devices the batch splits over: the (pod, data) axes when the
    global batch divides over them, else 1."""
    n = math.prod(mesh.sizes.get(a, 1) for a in _batch_axes(mesh))
    return n if shape.global_batch % n == 0 else 1


def argument_bytes(m: Measured, mesh: Mesh, overrides: Dict[str, Any]) -> int:
    """Exact per-device bytes of the step's arguments on ``mesh``."""
    cfg, shape = m.cfg, m.shape
    arg = _sharded_bytes(m.specs, batch_shardings(cfg, shape, mesh, m.specs))
    if shape.kind == "train":
        zero3 = overrides.get("zero", "zero3") == "zero3"
        arg += _sharded_bytes(m.params, param_shardings(cfg, m.params, mesh, zero=zero3))
        osh = param_shardings(cfg, m.params, mesh, zero=True)
        arg += _sharded_bytes(m.opt_state["m"], osh) + _sharded_bytes(m.opt_state["v"], osh)
        arg += _sharded_bytes(m.opt_state["step"], replicated(mesh))
    else:
        zero = bool(overrides.get("serve_zero", False))
        arg += _sharded_bytes(m.params, param_shardings(cfg, m.params, mesh, zero=zero))
    return arg


def cell_record(m: Measured, mesh_kind: str, mesh: Mesh,
                overrides: Dict[str, Any]) -> Dict[str, Any]:
    """The artifact of one measured cell on one mesh, under the reference's
    keys (``compile_s`` is the meta run's seconds)."""
    cfg, shape, c = m.cfg, m.shape, m.counts
    chips = mesh.size
    arg = argument_bytes(m, mesh, overrides)
    div = batch_shards(shape, mesh)
    temp = -(-(c.peak_bytes - c.arg_bytes) // div)
    out = -(-c.out_bytes // div)
    flops, byts = c.flops / chips, c.bytes_accessed / chips
    peak, peak_name = PEAK_FLOPS[cfg.dtype]
    terms = roofline(flops, byts, 0.0, hw=dataclasses.replace(H100_SXM, peak_flops=peak),
                     chips=chips, model_flops=_model_flops(cfg, shape))
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_kind, "chips": chips,
        "global_batch": shape.global_batch,
        "compile_s": m.seconds,
        "mem": {"argument_bytes": arg, "output_bytes": out, "temp_bytes": temp,
                "total_bytes": arg + temp + out},
        "temp_basis": TEMP_BASIS,
        "meta": c.to_dict(),
        "fits_hbm": arg + temp < H100_SXM.hbm_bytes,
        "hbm_bytes": H100_SXM.hbm_bytes,
        "cost": {"flops": flops, "bytes accessed": byts},
        "cost_basis": COST_BASIS,
        "collectives": None,
        "collectives_note": COLLECTIVES_NOTE,
        "peak_flops": peak, "peak_flops_basis": peak_name,
        "roofline": terms.to_dict(),
        "overrides": overrides,
    }


def _print(rec: Dict[str, Any], tag: str) -> None:
    m, t = rec["mem"], rec["roofline"]
    print(f"[{tag}] {rec['arch']} x {rec['shape']} x {rec['mesh']} ({rec['chips']} cards): "
          f"args {m['argument_bytes'] / 1e9:.3f} GB temp {m['temp_bytes'] / 1e9:.3f} GB "
          f"fits_hbm {rec['fits_hbm']}; compute {t['compute_s']:.3e}s "
          f"({rec['peak_flops_basis']}) memory {t['memory_s']:.3e}s collective not counted; "
          f"dominant {t['dominant']} useful_ratio {t['useful_flops_ratio']:.3f} "
          f"({rec['compile_s']:.2f} s)", flush=True)


def _skip(arch: str, shape_name: str, mesh_kind: str, why: str, **extra) -> Dict[str, Any]:
    return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "chips": _mesh(mesh_kind).size, **extra, "skipped": why}


def run_cells(arch: str, shape_name: str, mesh_kinds=("single",), *, probe: bool = False,
              verbose: bool = True, overrides: Optional[Dict[str, Any]] = None):
    """One meta run of (arch, shape), recorded on each mesh kind."""
    cfg, shape = get_config(arch), get_shape(shape_name)
    extra = {"probe": True} if probe else {}
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        recs = [_skip(arch, shape_name, k, why, **extra) for k in mesh_kinds]
        if verbose:
            for r in recs:
                print(f"[dryrun] {arch} x {shape_name} x {r['mesh']}: SKIP ({why})")
        return recs
    overrides = overrides or {}
    m = (_probe_cell if probe else _measure_cell)(cfg, shape, overrides)
    recs = []
    for k in mesh_kinds:
        rec = {**cell_record(m, k, _mesh(k), overrides), **extra}
        if verbose:
            _print(rec, "probe" if probe else "dryrun")
        recs.append(rec)
    return recs


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, verbose: bool = True,
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One cell at full depth."""
    return run_cells(arch, shape_name, (mesh_kind,), verbose=verbose, overrides=overrides)[0]


def probe_cell(arch: str, shape_name: str, mesh_kind: str, *, verbose: bool = True,
               overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One cell extrapolated from 1× and 2× its block pattern.

    The reference's probes exist because XLA counts a while-loop body once
    whatever its trip count, and need ``REPRO_UNROLL_INNER=1``.  Eager
    PyTorch counts every iteration, so the port's probes do not assert
    the flag: they only save time.  FLOPs are linear in depth here
    exactly (every layer of a pattern position counts the same), and so
    are a serving step's bytes.  A train step's bytes are not: autograd
    gives each layer's view of a stacked (R, ...) leaf a gradient of the
    whole leaf (``select_backward``) and sums R of them, which grows as
    R², so the probes under-count a train cell's bytes.  The temp bytes
    are extrapolated linearly too, an approximation."""
    return run_cells(arch, shape_name, (mesh_kind,), probe=True, verbose=verbose,
                     overrides=overrides)[0]


def fit_batch(cfg: ModelConfig, shape: ShapeConfig, budget: int):
    """The largest global batch (up to the shape's) whose meta peak is at
    most ``budget`` bytes on one device, with its measurement; (0, None)
    when even one sequence does not fit.  The peak grows about linearly in
    the batch: the line through batches 1 and 2 gives a first guess, and
    measured neighbours settle it."""
    runs = {}

    def fits(B: int) -> bool:
        if B not in runs:
            runs[B] = _measure_cell(cfg, dataclasses.replace(shape, global_batch=B), {})
        return runs[B].counts.peak_bytes <= budget

    top = shape.global_batch
    if not fits(1):
        return 0, None
    B = 1
    if top > 1:
        fits(2)
        p1, p2 = runs[1].counts.peak_bytes, runs[2].counts.peak_bytes
        B = top if p2 <= p1 else max(1, min(top, 1 + (budget - p1) // (p2 - p1)))
    while B > 1 and not fits(B):
        B -= 1
    while B < top and fits(B + 1):
        B += 1
    return B, runs[B]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--probe", action="store_true",
                    help="depth-extrapolated from 1x and 2x the block pattern")
    args = ap.parse_args(argv)
    if args.probe and args.tag == "baseline":
        args.tag = "probe"

    os.makedirs(args.out_dir, exist_ok=True)
    archs = list(ARCHS) if args.all or args.arch is None else [args.arch]
    shapes = [s.name for s in SHAPES] if args.all or args.shape is None else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            fnames = {k: os.path.join(args.out_dir, f"{args.tag}__{arch}__{shape}__{k}.json")
                      for k in meshes}
            todo = [k for k in meshes if not (args.skip_existing and os.path.exists(fnames[k]))]
            if not todo:
                continue
            try:
                recs = run_cells(arch, shape, todo, probe=args.probe)
            except Exception as e:  # noqa: BLE001 — record the failure
                recs = [{"arch": arch, "shape": shape, "mesh": k,
                         "error": f"{type(e).__name__}: {e}",
                         "traceback": traceback.format_exc()[-2000:]} for k in todo]
                n_fail += 1
                print(f"[dryrun] {arch} x {shape}: FAIL {e}")
            for rec in recs:
                with open(fnames[rec["mesh"]], "w") as f:
                    json.dump(rec, f, indent=2, default=str)
    print(f"[dryrun] done; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
