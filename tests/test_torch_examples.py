"""The port's examples, run on the CPU at tiny sizes, and its roofline
terms against the reference's.

Each example's ``main`` takes ``--device cpu`` (its default is the card)
and runs end to end on the plain versions; on the card they run through
the kernels (``chip_smoke.py``'s train phase).  ``roofline`` is pure
arithmetic, so its terms equal the reference's exactly on the same
hardware profile.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.hw import HardwareSpec as JHardwareSpec
from repro.roofline import roofline as j_roofline
from repro_torch.core import convnet
from repro_torch.core.hw import H100_SXM, TPU_V5E
from repro_torch.examples import pipeline_inference, quickstart, serve_lm, serve_volume
from repro_torch.examples import train_segmentation
from repro_torch.optim import tree
from repro_torch.roofline import RooflineTerms, roofline


def test_train_segmentation_loss_falls():
    losses = train_segmentation.main(["--device", "cpu", "--steps", "30"])
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < np.mean(losses[:10])


def test_every_parameter_gets_a_gradient():
    net = train_segmentation.SEG_NET
    params = convnet.init_params(net, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((1, 1, 9, 9, 9))
    fov = net.field_of_view()
    y = train_segmentation.labels_of(x, fov, 9 - fov + 1)
    loss, grads = train_segmentation.loss_and_grads(params, net, ["direct"] * 3, x, y)
    assert loss.ndim == 0 and not loss.requires_grad
    assert len(tree.leaves(grads)) == 6
    assert all(float(g.abs().sum()) > 0 for g in tree.leaves(grads))


def test_a_cut_graph_raises():
    """A parameter the loss does not reach is an error, not a silent
    ``None`` (what a kernel without a backward would leave)."""
    net = train_segmentation.SEG_NET
    params = convnet.init_params(net, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((1, 1, 9, 9, 9))
    y = torch.zeros((1, 1, 3, 3, 3))
    extra = params + [(torch.zeros(1), torch.zeros(1))]
    with pytest.raises(RuntimeError, match="no gradient"):
        train_segmentation.loss_and_grads(extra, net, ["direct"] * 3, x, y)


def test_quickstart():
    assert quickstart.main(["--device", "cpu"]) < 1e-3


def test_serve_volume():
    reqs = serve_volume.main(["--device", "cpu", "--volumes", "2", "--m", "1", "--batch", "2"])
    assert [r.done for r in reqs] == [True, True]
    assert all(np.isfinite(r.out).all() for r in reqs)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen2-vl-7b"])
def test_serve_lm(arch, capsys):
    reqs = serve_lm.main(["--device", "cpu", "--arch", arch, "--requests", "4",
                          "--slots", "2", "--max-new", "3"])
    assert all(r.done and len(r.out) == 3 for r in reqs)
    assert capsys.readouterr().out.rstrip().endswith("OK")


def test_pipeline_inference_two_ranks(capsys):
    pipeline_inference.main(["--device", "cpu"])
    assert capsys.readouterr().out.rstrip().endswith("OK")


@pytest.mark.parametrize("profile", [TPU_V5E, H100_SXM], ids=lambda h: h.name)
@pytest.mark.parametrize("work", [(3.2e15, 1.1e12, 4.0e10, 256, 7.0e17), (1.0e9, 5.0e10, 0.0, 1, 0.0),
                                  (0.0, 0.0, 1.0e9, 4, 1.0e12)])
def test_roofline_equals_reference(profile, work):
    flops, byts, coll, chips, model = work
    jhw = JHardwareSpec(**dataclasses.asdict(profile))
    want = j_roofline(flops, byts, coll, hw=jhw, chips=chips, model_flops=model)
    got = roofline(flops, byts, coll, hw=profile, chips=chips, model_flops=model)
    assert isinstance(got, RooflineTerms)
    assert got.to_dict() == want.to_dict()


def test_roofline_defaults_to_one_h100():
    got = roofline(67e12, 3.35e12, 0.0)
    assert got.compute_s == pytest.approx(1.0) and got.memory_s == pytest.approx(1.0)
    assert got.useful_flops_ratio == 0.0
    assert roofline(1.0, 0.0, 0.0, model_flops=1.0).useful_flops_ratio == 1.0
