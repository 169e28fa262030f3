"""ZNNi at pod scale, dry run: one device's share of the paper's own
workload on the production mesh, counted on ``meta`` tensors.

Volume inference for a Table III net, sharded both ways the paper
distributes work (§II): the `model` axis carries independent volumes
(16 volumes, one a device) and the `data` axis shards each volume along x
(16 x-shards) with a halo exchange before each conv and MPF layer
(``core.distributed_inference.halo_sharded_apply``).  Along the sharded
x axis a shard holds the plain-stride core extent m·P; the unsharded y
and z axes take the MPF-valid patch size.

One process runs one shard through ``halo_sharded_apply`` on meta
tensors.  Without a process group it is the chain's last rank, whose
halos are zeros, so it sees exactly a sharded device's shapes.  Recorded
per device: the argument bytes (parameters and the shard, exact), the
temp bytes (the meta peak less the arguments), the cost model's FLOPs
and streamed bytes (``core/cost_model.py``: ``FlopCounterMode`` counts no
FFT, and the meta run takes the plain versions, whose unfused traffic is
recorded beside them), and the halo bytes the device would send to its
left neighbour and receive from its right as its collective bytes.

Run:  PYTHONPATH=src python -m repro_torch.experiments.znni_dryrun [--net n537] [--m 4]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Sequence

import torch

from ..configs.base import ConvNetConfig
from ..configs.znni_nets import ZNNI_NETS
from ..core import convnet, planner
from ..core.cost_model import conv_cost, mpf_cost, pool_cost
from ..core.distributed_inference import halo_sharded_apply
from ..core.hw import H100_SXM
from ..launch.dryrun import DEFAULT_OUT
from ..launch.mesh import make_production_mesh
from ..roofline.analysis import count_step, roofline

F32 = 4
X_SHARDS = 16  # over 'data'
VOLUMES = 16  # over 'model'


def shard_layers(net: ConvNetConfig, prims: Sequence[str], S: int, x_local: int,
                 n_yz: int) -> List[Dict[str, Any]]:
    """Each layer as one shard runs it: the input extents after the halo
    (x grows by the halo, y and z do not), the batch (MPF multiplies it by
    p³), the halo's planes and bytes, and the cost model's FLOPs and
    streamed bytes."""
    f, n = net.in_channels, (x_local, n_yz, n_yz)
    out = []
    for i, layer in enumerate(net.layers):
        prim, k = prims[i], layer.size
        halo = k - 1 if (layer.kind == "conv" or prim == "mpf") else 0
        nin = (n[0] + halo, n[1], n[2])
        row = dict(layer=i, prim=prim, S=S, f=f, n=nin, halo=halo,
                   halo_bytes=S * f * halo * n[1] * n[2] * F32)
        if layer.kind == "conv":
            cost = conv_cost(prim, S, f, layer.out_channels, nin, k)
            f, n = layer.out_channels, (n[0], n[1] - k + 1, n[2] - k + 1)
        elif prim == "mpf":
            cost = mpf_cost(S, f, nin, k)
            S, n = S * k**3, tuple(x // k for x in nin)
        else:
            cost = pool_cost(S, f, nin, k)
            n = tuple(x // k for x in nin)
        row.update(flops=cost.flops, hbm_bytes=cost.hbm_bytes)
        out.append(row)
    return out


def run(net_name: str = "n537", m: int = 4, *, verbose: bool = True) -> Dict[str, Any]:
    """The record of one shard of a Table III net on the primitives
    ``plan_single`` picks for it on an H100 at fragment size ``m``."""
    net = ZNNI_NETS[net_name]
    plan = planner.plan_single(net, H100_SXM, max_m=m)
    return shard_record(net, m, [c.prim for c in plan.choices], verbose=verbose)


def shard_record(net: ConvNetConfig, m: int, prims: Sequence[str], *,
                 verbose: bool = True) -> Dict[str, Any]:
    """One device's shard of ``net`` on ``prims``, counted on meta."""
    x_local = m * net.total_pooling()
    n_in = net.valid_input_size(m)
    mesh = make_production_mesh()  # (16, 16) = ('data', 'model')
    chips = mesh.size
    S = VOLUMES // mesh.sizes["model"]
    params = convnet.init_params(net, torch.Generator(), device="meta")
    x = torch.empty((S, net.in_channels, x_local, n_in, n_in), device="meta")
    outs = []
    counts = count_step(lambda p, xl: outs.append(halo_sharded_apply(p, net, xl, prims)),
                        params, x)
    layers = shard_layers(net, prims, S, x_local, n_in)
    flops = sum(r["flops"] for r in layers)
    hbm = sum(r["hbm_bytes"] for r in layers)
    halo = sum(r["halo_bytes"] for r in layers)
    terms = roofline(flops, hbm, halo, hw=H100_SXM, chips=chips)
    rec = {
        "net": net.name, "volumes": VOLUMES, "x_shards": X_SHARDS, "n_in": n_in,
        "prims": prims, "x_local": x_local, "m": m,
        "output_shape": list(outs[0].shape),
        "mem": {"argument_bytes": counts.arg_bytes,
                "temp_bytes": counts.peak_bytes - counts.arg_bytes},
        "cost": {"flops": flops, "bytes accessed": hbm},
        "cost_basis": "core/cost_model.py per layer at the shard's shapes; 'meta' holds "
                      "the plain versions' unfused aten traffic",
        "meta": counts.to_dict(),
        "collectives": {"collective-permute": halo, "total": halo,
                        "halo_sent_bytes": halo, "halo_received_bytes": halo},
        "layers": layers,
        "roofline": terms.to_dict(),
        "hardware": H100_SXM.name,
    }
    if verbose:
        print(f"[znni-dryrun] {net.name} x {VOLUMES} volumes x {X_SHARDS} x-shards "
              f"({chips} H100s)")
        print(f"  plan: prims={prims} x_local={x_local} n_in={n_in} -> out "
              f"{rec['output_shape']}")
        print(f"  mem per card: args {rec['mem']['argument_bytes']} B, temp "
              f"{rec['mem']['temp_bytes']} B")
        print(f"  cost model: flops={flops:.3e} bytes={hbm:.3e} (meta, plain versions: "
              f"{counts.bytes_accessed:.3e}); halo sent = received {halo} B")
        print(f"  roofline: compute={terms.compute_s:.3e}s memory={terms.memory_s:.3e}s "
              f"collective={terms.collective_s:.3e}s dominant={terms.dominant}", flush=True)
    return rec


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="n537")
    ap.add_argument("--m", type=int, default=4, help="fragment size per x-shard")
    ap.add_argument("--out-dir", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    rec = run(args.net, args.m)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, f"znni__{args.net}__single.json"), "w") as f:
        json.dump(rec, f, indent=2, default=str)
    print("OK")
    return rec


if __name__ == "__main__":
    main()
