"""Hardware model constants.  The port's target is ``H100_SXM``; the
reference package's profiles (TPU v5e, the paper's two machines) stay so
plans can be compared with the reference field for field.

A ``HardwareSpec`` is one *device profile*; the heterogeneous planner
(``planner.plan_hetero``) takes a **set** of profiles and prices each
pipeline stage on its own profile.  ``ici_bw`` doubles as the device's
host-link bandwidth (QPI for the Xeon, PCIe for the Titan X, ICI for the
TPU): the split-point activation hand-off travels through host RAM, so it
is priced over the slower of the two devices' links
(``host_link_bw``).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12  # bf16 FLOP/s per chip
    hbm_bw: float = 819e9  # bytes/s per chip
    hbm_bytes: int = 16 * 2**30  # per chip
    ici_bw: float = 50e9  # bytes/s per link; also the host-link bandwidth
    vmem_bytes: int = 128 * 2**20
    # MXU native tile (used by kernel BlockSpec choices and napkin math)
    mxu: int = 128


def host_link_bw(a: "HardwareSpec", b: "HardwareSpec") -> float:
    """Bandwidth of a host-RAM hand-off between two devices.

    The activation crosses producer link → host RAM → consumer link; the
    slower link bounds the steady-state rate (the paper's §VII-C hand-off
    cost, PCIe on its machines).
    """
    return min(a.ici_bw, b.ici_bw)


TPU_V5E = HardwareSpec()

H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops=67e12,  # fp32 outside the tensor cores
    hbm_bw=3.35e12,  # HBM3
    hbm_bytes=80 * 10**9,
    ici_bw=64e9,  # host link: PCIe Gen5 x16, about 64 GB/s each way
    vmem_bytes=50 * 2**20,  # L2
)
"""NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 Tensor Core GPU data sheet
(SXM column, dense rates): 67 TFLOP/s fp32, 3.35 TB/s HBM3, 80 GB, PCIe
Gen5 x16 to the host, 50 MB L2 standing in for on-chip memory."""

# The paper's two machines, for reproducing its tables analytically.
XEON_E7_8890V3_4WAY = HardwareSpec(
    name="4-way Xeon E7-8890v3",
    peak_flops=72 * 2.5e9 * 16,  # 72 cores * AVX2 fp32 FMA throughput
    hbm_bw=85e9,  # 4-socket aggregate stream bw (approx)
    hbm_bytes=256 * 2**30,
    ici_bw=16e9,  # QPI-ish
    vmem_bytes=45 * 2**20,  # LLC
)

TITAN_X = HardwareSpec(
    name="Titan X (Maxwell)",
    peak_flops=6.1e12,
    hbm_bw=336e9,
    hbm_bytes=12 * 2**30,
    ici_bw=12e9,  # PCIe 3.0 x16 ~ 12 GB/s effective
    vmem_bytes=3 * 2**20,
)

# The paper's CPU+GPU machine as a device set: the canonical argument to
# ``planner.plan_hetero`` / ``plan_all_strategies(devices=...)`` for
# reproducing its CPU-vs-GPU-vs-pipeline tables analytically.
PAPER_MACHINES = (XEON_E7_8890V3_4WAY, TITAN_X)
