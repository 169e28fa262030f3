"""The traced run: spans the harness records around the calls into each
layer, the kernel wrappers' calls with their work, and a summary of the
device trace kept in memory (no trace file is written).

Spans are ``torch.profiler.record_function`` ranges named ``bench.<what>``
(``bench.window``, ``bench.submit``, ``bench.step``, ``bench.wait``); each
recorded kernel wrapper call runs inside ``bench.call.<wrapper>``, so the
device time of everything it launched is the range's device time,
whatever the kernels are called.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import importlib.util
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

import work

SPAN = "bench."
CALL = "bench.call."
HOST_SPANS = ("submit", "step", "wait")
NAME_CHARS = 160  # of a device operation's name in the breakdown

WRAPPERS_DIR = Path(__file__).resolve().parent / "wrappers"


def shape(t) -> Tuple[int, ...]:
    return tuple(int(s) for s in t.shape)


def wrappers() -> Dict[str, object]:
    """Every ``wrappers/<name>.py`` by name: the kernel wrapper ``<name>``
    of ``repro_torch.kernels.<MODULE>`` whose calls are recorded, and
    ``work_of(args, kwargs, out)``, the (bytes, FLOPs) of one call."""
    found = {}
    for path in sorted(WRAPPERS_DIR.glob("*.py")):
        spec = importlib.util.spec_from_file_location(f"bench_wrapper_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        found[path.stem] = mod
    return found


class CallRecorder:
    """While entered, every call to a wrapper of ``wrappers/`` runs inside
    its own span, and its least time by its ``work_of`` is summed by
    wrapper."""

    def __init__(self):
        self.calls: Dict[str, int] = defaultdict(int)
        self.least_s: Dict[str, float] = defaultdict(float)
        self._saved: List = []

    def __enter__(self):
        for name, entry in wrappers().items():
            mod = importlib.import_module(f"repro_torch.kernels.{entry.MODULE}")
            fn = getattr(mod, name)

            def wrapped(*args, _fn=fn, _name=name, _work=entry.work_of, **kwargs):
                with torch.profiler.record_function(CALL + _name):
                    out = _fn(*args, **kwargs)
                if out.is_cuda:  # the plain versions launch no kernel
                    nbytes, flops = _work(args, kwargs, out)
                    self.calls[_name] += 1
                    self.least_s[_name] += work.least_seconds(nbytes, flops)
                return out

            self._saved.append((mod, name, fn))
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()
        return False


def roofline_share(run, wrappers) -> Optional[float]:
    """The wrappers' calls' least time over the device time of the kernels
    they launched, in %; None when the run recorded none of them."""
    if run.recorder is None or run.summary is None:
        return None
    least = sum(run.recorder.least_s.get(w, 0.0) for w in wrappers)
    spent = sum(run.summary["call_device_s"].get(w, 0.0) for w in wrappers)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent


def idle_share(run) -> Optional[float]:
    """The share of the traced window in which no kernel or copy ran on
    the device, in %; None without a trace or device time."""
    s = run.summary
    if s is None or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def span(name: str, on: bool):
    """A ``bench.<name>`` range in the trace, or nothing when not tracing."""
    return torch.profiler.record_function(SPAN + name) if on else contextlib.nullcontext()


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _union(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """Disjoint, sorted pieces of the intervals' union inside [lo, hi]."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, top: int = 10) -> Optional[Dict]:
    """Busy and window seconds, device seconds by operation, the longest
    idle gaps by the host span they fall in, and each recorded wrapper's
    device seconds; None when the trace holds no window.

    A kernel belongs to a wrapper call when the runtime call that launched
    it (matched by correlation id) ran inside the call's span on the host.
    """
    events = prof.events()
    window = [e for e in events if e.name == SPAN + "window" and not _is_device(e)]
    if not window:
        return None
    lo, hi = window[0].time_range.start, window[0].time_range.end
    kernels, host, calls = [], [], []
    launched_at: Dict[int, float] = {}
    by_op: Dict[str, float] = defaultdict(float)
    for e in events:
        if _is_device(e):
            if not (e.name.startswith(SPAN) or getattr(e, "is_user_annotation", False)):
                kernels.append(e)
        elif e.name.startswith(CALL):
            calls.append((e.time_range.start, e.time_range.end, e.name[len(CALL):]))
        elif e.name.startswith(SPAN) and e.name[len(SPAN):] in HOST_SPANS:
            host.append((e.time_range.start, e.time_range.end, e.name[len(SPAN):]))
        elif e.name.startswith("cu") and e.id > 0:  # a CUDA runtime or driver call
            launched_at[e.id] = e.time_range.start
    device = []
    by_call: Dict[str, float] = defaultdict(float)
    calls.sort()
    call_starts = [c[0] for c in calls]
    matched = 0
    for e in kernels:
        a, b = e.time_range.start, e.time_range.end
        if b > lo and a < hi:
            device.append((a, b))
            by_op[e.name] += (min(b, hi) - max(a, lo)) / 1e6
        t = launched_at.get(e.id)
        if t is None:
            continue
        matched += 1
        k = bisect.bisect_right(call_starts, t) - 1
        if k >= 0 and calls[k][1] >= t:
            by_call[calls[k][2]] += (b - a) / 1e6
    busy = _union(device, lo, hi)
    gaps, prev = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host.sort()
    starts = [s for s, _, _ in host]
    labelled = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(starts, mid) - 1
        what = host[k][2] if k >= 0 and host[k][1] >= mid else "other"
        labelled.append([what, (b - a) / 1e6])
    labelled.sort(key=lambda r: -r[1])
    idle_by_span: Dict[str, float] = defaultdict(float)
    for what, s in labelled:
        idle_by_span[what] += s
    return dict(
        window_s=(hi - lo) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        device_ops=sorted(([k[:NAME_CHARS], v] for k, v in by_op.items()),
                          key=lambda r: -r[1])[:top],
        idle_gaps=labelled[:top],
        idle_by_span=dict(idle_by_span),
        call_device_s=dict(by_call),
        kernels=len(kernels),
        kernels_matched=matched,
    )
