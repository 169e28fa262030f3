"""Roofline terms of a workload on a device profile (DESIGN.md §7).

  compute    = FLOPs_per_device / peak_FLOP/s
  memory     = bytes_per_device / HBM_bw
  collective = collective_bytes_per_device / link_bw

The port of ``RooflineTerms`` and ``roofline`` from
``repro.roofline.analysis``: the same arithmetic, so on the same profile
the terms equal the reference's.  Here ``hw`` defaults to the port's
target, ``H100_SXM``, and ``chips`` to one card.  The reference's
``collective_bytes`` and ``analyze_compiled`` read XLA's optimized HLO and
``compiled.cost_analysis()``; PyTorch has neither, so they have no
counterpart here: callers pass FLOPs and bytes counted from shapes.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

from ..core.hw import H100_SXM, HardwareSpec


@dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0
    useful_flops_ratio: float = 0.0  # MODEL_FLOPS / (FLOPs * chips)

    def to_dict(self):
        return asdict(self)


def roofline(
    flops_per_device: float,
    bytes_per_device: float,
    coll_bytes_per_device: float,
    *,
    hw: HardwareSpec = H100_SXM,
    chips: int = 1,
    model_flops: float = 0.0,
) -> RooflineTerms:
    c = flops_per_device / hw.peak_flops
    m = bytes_per_device / hw.hbm_bw
    link = coll_bytes_per_device / hw.ici_bw
    dom = max(("compute", c), ("memory", m), ("collective", link), key=lambda t: t[1])[0]
    ratio = model_flops / (flops_per_device * chips) if flops_per_device else 0.0
    return RooflineTerms(
        flops_per_device, bytes_per_device, coll_bytes_per_device,
        c, m, link, dom, model_flops, ratio,
    )
