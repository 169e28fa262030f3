"""The program's stages in a traced run: what the ``znni.`` spans of
``repro_torch.trace`` say about the window's idle device and its device
seconds.

``summarize(events)`` reads the profiler's events of a traced window (the
same ``prof.events()`` that ``devtrace.summarize`` reads) and returns:

- ``idle_by_stage``: each idle gap's seconds divided among the innermost
  program spans covering it; a part no program span covers keeps the
  gap's label in ``devtrace`` (``step``, ``submit``, ``wait`` or
  ``other``).  The values sum to the window's idle.
- ``stage_device_s``: the device seconds (inside the window) of every
  kernel or copy, put to the innermost program span around its launch,
  matched by correlation id as ``devtrace`` matches wrapper calls;
  ``other`` where no span was around the launch or none was matched.
- ``stage_host_s``, ``stage_calls``: each span name's summed duration on
  the host, and its count.
- ``idle_gaps``: the longest gaps as ``devtrace`` labels them, with
  ``/<stage>`` added for the stage covering most of the gap.
- ``stage_copy_s``: per stage, the device seconds of PyTorch's copy
  kernels (``COPY`` in the kernel's full name, which the truncated names
  of ``devtrace``'s ``device_ops`` do not show).
- ``ticks`` and ``tick_host_ms``: the ``engine.step`` spans in the window,
  and their mean duration less the time inside device stages
  (``DEVICE_STAGES``, ``exec.layer.*``): the host-only time of a tick.

Span names are given without the ``znni.`` prefix.  Nothing here is run
by ``run.py``: ``stage_table.py`` reads traced runs with it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import devtrace

PROGRAM = "znni."
# stages that launch device work or wait for it; ``exec.layer.<i>`` too
DEVICE_STAGES = frozenset((
    "exec.begin_sweep", "exec.upload", "exec.segment_fft", "exec.assemble",
    "exec.layer0", "exec.recombine", "exec.walk", "exec.store", "exec.copy_back",
))
COPY = "direct_copy_kernel"


def is_device_stage(name: str) -> bool:
    return name in DEVICE_STAGES or name.startswith("exec.layer.")


def _innermost(spans: List[Tuple[float, float, str]], lo: float, hi: float):
    """Pieces ``(a, b, name)`` covering [lo, hi] in order, each named by
    the innermost span over it (None where no span is)."""
    points = []
    for k, (a, b, _) in enumerate(spans):
        if b <= a:
            continue
        points.append((a, 1, -b, k))  # at one time, ends first, outer starts first
        points.append((b, 0, -a, k))
    points.sort()
    pieces: List[List] = []
    stack: List[int] = []
    t = lo
    for when, opens, _, k in points:
        when = min(max(when, lo), hi)
        if when > t:
            name = spans[stack[-1]][2] if stack else None
            if pieces and pieces[-1][2] == name and pieces[-1][1] == t:
                pieces[-1][1] = when
            else:
                pieces.append([t, when, name])
            t = when
        if opens:
            stack.append(k)
        else:
            stack.remove(k)
    if hi > t:
        pieces.append([t, hi, None])
    return pieces


def _union_length(intervals, lo: float, hi: float) -> float:
    return sum(b - a for a, b in devtrace._union(intervals, lo, hi))


def summarize(events, top: int = 10) -> Optional[Dict]:
    """The stages of the traced window in ``events``; None when the trace
    holds no window."""
    window = [e for e in events
              if e.name == devtrace.SPAN + "window" and not devtrace._is_device(e)]
    if not window:
        return None
    lo, hi = window[0].time_range.start, window[0].time_range.end
    kernels, host, spans = [], [], []
    launched_at: Dict[int, float] = {}
    for e in events:
        name = e.name
        if devtrace._is_device(e):
            if not (name.startswith((devtrace.SPAN, PROGRAM))
                    or getattr(e, "is_user_annotation", False)):
                kernels.append(e)
        elif name.startswith(PROGRAM):
            spans.append((e.time_range.start, e.time_range.end, name[len(PROGRAM):]))
        elif name.startswith(devtrace.SPAN) and name[len(devtrace.SPAN):] in devtrace.HOST_SPANS:
            host.append((e.time_range.start, e.time_range.end, name[len(devtrace.SPAN):]))
        elif name.startswith("cu") and e.id > 0:  # a CUDA API call; its id names what it launched
            launched_at[e.id] = e.time_range.start
    spans.sort(key=lambda s: (s[0], -s[1]))
    pieces = _innermost(spans, lo, hi)
    piece_starts = [p[0] for p in pieces]

    def stage_at(t: float) -> Optional[str]:
        k = bisect.bisect_right(piece_starts, t) - 1
        return pieces[k][2] if k >= 0 and pieces[k][1] >= t else None

    # device seconds by the stage around each launch
    device, stage_device, stage_copy = [], defaultdict(float), defaultdict(float)
    for e in kernels:
        a, b = e.time_range.start, e.time_range.end
        if not (b > lo and a < hi):
            continue
        device.append((a, b))
        s = (min(b, hi) - max(a, lo)) / 1e6
        t = launched_at.get(e.id)
        what = (stage_at(t) if t is not None else None) or "other"
        stage_device[what] += s
        if COPY in e.name:
            stage_copy[what] += s

    # idle gaps, labelled as devtrace labels them, then split by stage
    busy = devtrace._union(device, lo, hi)
    gaps, prev = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host.sort()
    host_starts = [h[0] for h in host]
    idle_by_stage: Dict[str, float] = defaultdict(float)
    labelled = []
    k = 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        j = bisect.bisect_right(host_starts, mid) - 1
        label = host[j][2] if j >= 0 and host[j][1] >= mid else "other"
        while k < len(pieces) and pieces[k][1] <= a:
            k += 1
        cover: Dict[str, float] = defaultdict(float)
        j = k
        while j < len(pieces) and pieces[j][0] < b:
            pa, pb, name = pieces[j]
            part = min(pb, b) - max(pa, a)
            if part > 0:
                idle_by_stage[name or label] += part / 1e6
                if name is not None:
                    cover[name] += part
            j += 1
        most = max(cover, key=cover.get) if cover else None
        labelled.append([label if most is None else f"{label}/{most}", (b - a) / 1e6])
    labelled.sort(key=lambda r: -r[1])

    # host time by span, and each tick's host-only time
    stage_host, stage_calls = defaultdict(float), defaultdict(int)
    inside = [s for s in spans if lo <= s[0] <= hi]
    for a, b, name in inside:
        stage_host[name] += (min(b, hi) - a) / 1e6
        stage_calls[name] += 1
    device_spans = [s for s in inside if is_device_stage(s[2])]
    dev_starts = [s[0] for s in device_spans]
    ticks = []
    for a, b, name in inside:
        if name != "engine.step":
            continue
        i, j = bisect.bisect_left(dev_starts, a), bisect.bisect_right(dev_starts, b)
        on_device = _union_length([s[:2] for s in device_spans[i:j]], a, b)
        ticks.append((b - a - on_device) / 1e3)
    return dict(
        idle_by_stage=dict(idle_by_stage),
        stage_device_s=dict(stage_device),
        stage_host_s=dict(stage_host),
        stage_calls=dict(stage_calls),
        idle_gaps=labelled[:top],
        stage_copy_s=dict(stage_copy),
        ticks=len(ticks),
        tick_host_ms=sum(ticks) / len(ticks) if ticks else None,
    )
