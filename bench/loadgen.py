"""The one traffic generator: reads a mix's parameters from
``traffic/<mix>.json`` and makes, from the seed, the volumes that it
offers.  How they are offered is the mix's ``kind``: a module
``kinds/<kind>.py``, found by that name, that defines

* ``validate(traffic)``: raises ``ValueError`` on a mix it cannot run;
* ``plan(traffic, seed, seconds)``: what the window offers and when,
  from the seed;
* ``warm_up(engine, vols, traffic)``: runs every shape the window uses
  once;
* ``window(run, engine, vols, plan, seconds)``: the measured window;
  fills ``run``'s window seconds, voxels, latencies, submit times and
  patches, and returns its state;
* ``answers_due(engine, vols, state)``: every request due in the window,
  submitting those it never reached, with the pool index of each;
* ``reference(layers, params, vols, need, device, *, budget, tf32)``: the
  plain reference's output of each pool volume in ``need``, computed in
  pieces of at most ``budget`` bytes.

Volumes are N(0, 1) float32, drawn on the device by a generator seeded
from the run's seed, and handed to the engine as host arrays.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# offsets that keep the volumes' and the order's streams apart from the
# weights' (a seed may be any whole number up to 2**64 - 1)
VOLUME_STREAM = 0x5EED_0001
ORDER_STREAM = 0x5EED_0002


def kind(name: str):
    """The module ``kinds/<name>.py``."""
    path = ROOT / "kinds" / f"{name}.py"
    if not path.is_file():
        known = sorted(p.stem for p in (ROOT / "kinds").glob("*.py"))
        raise ValueError(f"no traffic kind {name!r}; known: {known}")
    spec = importlib.util.spec_from_file_location(f"bench_kind_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(root: Path, mix: str) -> Dict:
    """The mix's parameters, checked by its kind."""
    traffic = json.loads((root / "traffic" / f"{mix}.json").read_text())
    kind(str(traffic.get("kind"))).validate(traffic)
    return traffic


def stream_seed(seed: int, stream: int) -> int:
    return (int(seed) + stream) % (1 << 64)


def order_rng(seed: int) -> np.random.Generator:
    """The stream that orders a run's requests over the pool."""
    return np.random.default_rng(stream_seed(seed, ORDER_STREAM))


def input_shape(traffic: Dict, core: int, fov: int) -> tuple:
    """Input extent per axis of one request: its cores of output plus the
    field of view less one."""
    return tuple(int(c) * core + fov - 1 for c in traffic["cores"])


def make_volumes(traffic: Dict, in_channels: int, shape: Sequence[int], seed: int,
                 device) -> List[np.ndarray]:
    """The mix's pool of volumes (in_channels, *shape), drawn on ``device``
    in one call and copied to the host."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, VOLUME_STREAM))
    n = int(traffic["pool"])
    vols = torch.randn((n, in_channels) + tuple(shape), generator=gen, device=device)
    host = vols.cpu().numpy()
    del vols
    return [host[i] for i in range(n)]
