"""Atomic, async checkpointing of the port's trees (a JSON manifest + raw
leaf payloads).

Layout:  <dir>/step_<N>/          (atomic: written as .tmp-<id>, then renamed)
             manifest.json        step, leaf count, dtypes, shapes
             arrays.npz           each leaf's bytes (uint8), in leaf order

The port of ``repro.checkpoint.ckpt``, which writes its manifest with
msgpack; the port keeps to the standard library (the card's machine has
no msgpack).  Leaves are tensors; a ``QTensor`` is two leaves (payload,
scale) and ``None`` holds none, as in the reference's tree walk.  Each
payload is the leaf's raw bytes, so bfloat16 round-trips bit for bit
(numpy has no bfloat16); the manifest's dtype and shape restore it.
``restore`` takes a ``device`` where the reference takes shardings.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, Optional

import numpy as np
import torch

from ..kernels.dispatch import DeviceLike, resolve_device
from ..optim import tree

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _step_dir(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}")


def save(path: str, step: int, t: Any, *, async_: bool = False) -> Optional[threading.Thread]:
    """Write the checkpoint of ``step``.  The leaves are copied to host
    memory before this returns; with ``async_=True`` the files are written
    by a thread, which is returned."""
    host = [leaf.detach().to("cpu", copy=True).contiguous() for leaf in tree.leaves(t)]
    manifest = {
        "step": step,
        "n_leaves": len(host),
        "dtypes": [_dtype_name(h.dtype) for h in host],
        "shapes": [list(h.shape) for h in host],
    }
    payload = [h.reshape(-1).view(torch.uint8).numpy() for h in host]

    def write():
        final = _step_dir(path, step)
        # unique tmp dir: concurrent writers of one step (an async save and
        # a later one) do not collide; the first rename wins
        tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        np.savez(os.path.join(tmp, ARRAYS), *payload)
        try:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except OSError:
            if os.path.isdir(final):  # another writer won the race
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                raise

    if async_:
        th = threading.Thread(target=write, daemon=True)
        th.start()
        return th
    write()
    return None


def _steps(path: str):
    if not os.path.isdir(path):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(path)
                  if d.startswith("step_") and ".tmp" not in d)


def latest_step(path: str) -> Optional[int]:
    steps = _steps(path)
    return steps[-1] if steps else None


def restore(path: str, step: int, tree_like: Any, device: DeviceLike = None) -> Any:
    """The checkpoint of ``step`` in the structure of ``tree_like``, every
    leaf on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    final = _step_dir(path, step)
    with open(os.path.join(final, MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(final, ARRAYS)) as z:
        raw = [z[k] for k in z.files]
    like = tree.leaves(tree_like)
    if len(raw) != len(like) or manifest["n_leaves"] != len(like):
        raise ValueError(f"checkpoint has {len(raw)} leaves, expected {len(like)}")
    host = [
        torch.from_numpy(r.copy()).view(getattr(torch, dt)).reshape(shape)
        for r, dt, shape in zip(raw, manifest["dtypes"], manifest["shapes"])
    ]
    return tree.unflatten(tree_like, [h.to(dev) for h in host])


def prune_old(path: str, keep: int = 3) -> None:
    for s in _steps(path)[:-keep]:
        shutil.rmtree(_step_dir(path, s))
