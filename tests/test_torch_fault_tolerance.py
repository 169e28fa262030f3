"""The port's ``restore_with_remesh`` against the reference's round trip
(``tests/test_fault_tolerance.py::test_restore_with_remesh_roundtrip``),
and the host mesh without a card.

The values come back equal on a one-device CPU mesh; a mesh of more
devices, or a logical production mesh, raises rather than leave a tensor
where it was.  ``make_host_mesh()`` asks for the cards and raises on a
machine without one: the test skips only where a card is present, which
it decides inside the test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding, PartitionSpec as JP

from repro.distributed.fault_tolerance import restore_with_remesh as jax_restore_with_remesh
from repro_torch.distributed.fault_tolerance import restore_with_remesh
from repro_torch.distributed.sharding import NamedSharding, P, replicated
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh


def test_restore_with_remesh_roundtrip():
    want = jax_restore_with_remesh({"w": jnp.arange(8.0)},
                                   {"w": JNamedSharding(jax.make_mesh((1,), ("data",)), JP())})
    mesh = make_host_mesh(device="cpu")
    assert mesh.shape == (1, 1) and mesh.devices == ("cpu",)
    tree = {"w": torch.arange(8.0), "blocks": {"0": {"k": torch.ones(2, 3)}}}
    out = restore_with_remesh(tree, {"w": replicated(mesh),
                                     "blocks": {"0": {"k": NamedSharding(mesh, P("data"))}}})
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(want["w"]))
    assert out["w"].device.type == "cpu"
    assert torch.equal(out["blocks"]["0"]["k"], tree["blocks"]["0"]["k"])


@pytest.mark.parametrize("mesh", [make_production_mesh(),
                                  Mesh(("data", "model"), (2, 1), ("cpu", "cpu"))],
                         ids=["logical 16x16", "two devices"])
def test_restore_with_remesh_refuses_a_mesh_of_many_devices(mesh):
    with pytest.raises(ValueError, match="one-device mesh"):
        restore_with_remesh({"w": torch.zeros(4)}, {"w": replicated(mesh)})


def test_make_host_mesh_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: make_host_mesh() covers it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
