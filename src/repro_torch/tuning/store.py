"""Persisted per-hardware tuned configs: the autotuner's output, keyed by
(device kind, net).

ZNNi's central claim is that the throughput-optimal primitive schedule and
its knobs are a *property of the hardware*: the paper re-derives them per
machine (Table IV/V differ between the 4-way CPU and the Titan X).  This
module is the port's equivalent of those tables: ``repro_torch.tuning.
autotune`` sweeps the executor's tunables on the device it runs on and
persists the winner here as JSON; ``PlanExecutor``, ``VolumeEngine`` and
``ShardedVolumeEngine`` load it under ``tuned="auto"``, so a fresh process
on the same hardware starts from the tuned point instead of defaults.

Key schema (the reference's, ``docs/architecture.md`` "Kernels &
autotuning"):

* file: ``src/repro_torch/tuning/configs/<device_kind>__<net>.json``;
* ``device_kind``: ``torch.cuda.get_device_name`` of the card, ``cpu`` on
  the CPU, lower-cased with every other run of characters collapsed to
  ``-`` (``nvidia-h100-80gb-hbm3``);
* ``net``: ``ConvNetConfig.name`` (``bench-net``, ``n337``).

A config never overrides plan *geometry* when the caller supplies a Plan
(m and batch are part of the planner's costed contract); it fills the
execution knobs ``fuse_pairs``, ``fprime_chunk`` and ``fuse_os``, and
supplies m and batch only when the caller left them unset on a plan-less
build.

Schema v2: ``fprime_chunk`` may be a per-ABSOLUTE-layer schedule (a list
in JSON, loaded as a tuple; ``None`` at pools and past the end, resolved
per layer by ``primitives.layer_fprime_chunk``); files from a FUTURE
schema version are ignored rather than misread.

Departure from the reference: the port's ``TunedConfig`` has no
``use_pallas`` and no ``xla_flags``.  The XLA flag bundles mean nothing to
PyTorch, and a tuned file never switches the card's kernels off (the
port's one dispatch rule, ``kernels.dispatch``, has no fallback).  The
loader drops unknown keys, so the reference's files, which carry both,
load unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..kernels.dispatch import DeviceLike, resolve_device

CONFIG_DIR = Path(__file__).parent / "configs"

_SCHEMA_VERSION = 2


@dataclass(frozen=True)
class TunedConfig:
    """One hardware profile's winning knobs for one net.

    ``None`` fields mean "no opinion: keep the caller's value".
    """

    device_kind: str
    net: str
    m: Optional[int] = None
    batch: Optional[int] = None
    # scalar (every chunked layer) or per-absolute-layer schedule (tuple,
    # None at pools / unchunked layers), see primitives.layer_fprime_chunk
    fprime_chunk: Union[int, Tuple[Optional[int], ...], None] = None
    fuse_pairs: Optional[bool] = None
    fuse_os: Optional[bool] = None  # fused halo-emitting strip epilogue
    seg_core: Optional[int] = None
    source: str = "autotune"  # autotune | manual
    measured_voxps: Optional[float] = None
    tuned_at: Optional[str] = None  # ISO date, stamped by the tuner CLI

    def provenance(self) -> Dict[str, Any]:
        """The compact dict a run reports as its ``tuned_config``."""
        return {
            "device_kind": self.device_kind,
            "net": self.net,
            "fprime_chunk": self.fprime_chunk,
            "fuse_pairs": self.fuse_pairs,
            "fuse_os": self.fuse_os,
            "source": self.source,
            "tuned_at": self.tuned_at,
        }


def normalize_device_kind(
    kind: Optional[str] = None, device: DeviceLike = None
) -> str:
    """Canonical hardware-profile key (filesystem-safe, stable across runs).

    Without ``kind`` it is read off ``device`` (``None``: the card):
    ``torch.cuda.get_device_name`` on a CUDA device, ``"cpu"`` on the CPU.
    """
    if kind is None:
        dev = resolve_device(device)
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return re.sub(r"[^a-z0-9.-]+", "-", kind.strip().lower()).strip("-")


def config_key(
    net: str, device_kind: Optional[str] = None, *, device: DeviceLike = None
) -> str:
    return f"{normalize_device_kind(device_kind, device)}__{net}"


def config_path(
    net: str,
    device_kind: Optional[str] = None,
    root: Optional[Path] = None,
    *,
    device: DeviceLike = None,
) -> Path:
    return Path(root or CONFIG_DIR) / f"{config_key(net, device_kind, device=device)}.json"


def save_tuned_config(cfg: TunedConfig, *, root: Optional[Path] = None) -> Path:
    path = config_path(cfg.net, cfg.device_kind, root=root)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"schema_version": _SCHEMA_VERSION, **dataclasses.asdict(cfg)}
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return path


def load_tuned_config(
    net: str,
    device_kind: Optional[str] = None,
    *,
    root: Optional[Path] = None,
    device: DeviceLike = None,
) -> Optional[TunedConfig]:
    """The persisted winner for (this hardware, ``net``), or ``None``.

    The hardware is ``device_kind`` if given, else ``device``'s (``None``:
    the card).  Missing file → ``None`` (callers keep their defaults); a
    file with a future schema version is ignored rather than misread.
    """
    path = config_path(net, device_kind, root=root, device=device)
    if not path.exists():
        return None
    payload = json.loads(path.read_text())
    if payload.pop("schema_version", _SCHEMA_VERSION) > _SCHEMA_VERSION:
        return None
    fp = payload.get("fprime_chunk")
    if isinstance(fp, list):  # JSON has no tuples: schedule round-trip
        payload["fprime_chunk"] = tuple(None if v is None else int(v) for v in fp)
    fields = {f.name for f in dataclasses.fields(TunedConfig)}
    return TunedConfig(**{k: v for k, v in payload.items() if k in fields})
