"""The port's sharding rules against the JAX reference, on the CPU.

Mirrors every case of ``tests/test_sharding.py`` on the same logical
16×16 mesh, then holds every spec equal to the reference's leaf for leaf:
``param_shardings`` for all ten archs with ``zero`` off and on (the
reference's specs captured with its test's ``Cap`` trick on
``jax.eval_shape(model.init)``; the port's on a ``meta`` init), and
``batch_shardings`` for every arch and all four shapes (the reference on
its ``input_specs`` ShapeDtypeStructs, the port on its ``meta`` ones).
The rules are pure, so the comparison is exact.
"""

import functools

import jax
import pytest
import torch

import repro.distributed.sharding as jax_sh
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCHS, get_shape
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import build_model


def _mesh16():
    # the 16x16 LOGICAL mesh the rules key on
    return Mesh(("data", "model"), (16, 16))


class _JaxMesh16:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


def _flatten(tree, path=()):
    """{path: NamedSharding} of a port sharding tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, path + (str(k),)))
        return out
    if tree is None:
        return {}
    return {"/".join(path): tree}


def _specs(cfg, mesh, zero=False):
    params = build_model(cfg).init(torch.Generator(), device="meta")
    tree = sh.param_shardings(cfg, params, mesh, zero=zero)
    return {k: s.spec for k, s in _flatten(tree).items()}


def _captured(fn, *args, **kw):
    """The reference's specs by path: its NamedSharding replaced by a
    recorder while ``fn`` builds the tree (its own test's ``Cap`` trick)."""

    class Cap:
        def __init__(self, mesh, spec):
            self.mesh, self.spec = mesh, spec

    orig = jax_sh.NamedSharding
    jax_sh.NamedSharding = Cap
    try:
        tree = fn(*args, **kw)
    finally:
        jax_sh.NamedSharding = orig
    flat = jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, Cap))
    return {"/".join(str(getattr(p, "key", p)) for p in path): tuple(leaf.spec)
            for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def _jax_params_sds(arch):
    return jax.eval_shape(jax_build_model(JAX_ARCHS[arch]).init, jax.random.PRNGKey(0))


# -- the reference's cases ---------------------------------------------------------


def test_jamba_experts_use_expert_parallelism():
    specs = _specs(ARCHS["jamba-v0.1-52b"], _mesh16())
    key = next(k for k in specs if "blocks/1/ffn/w_in" in k)
    assert specs[key][-3] == "model"


def test_mixtral_experts_fall_back_to_tensor_parallel():
    specs = _specs(ARCHS["mixtral-8x7b"], _mesh16())
    key = next(k for k in specs if "ffn/w_in" in k)
    assert specs[key][-1] == "model" and specs[key][-3] is None


def test_qwen15_attention_replicated_mlp_sharded():
    specs = _specs(ARCHS["qwen1.5-4b"], _mesh16())
    wq = next(k for k in specs if k.endswith("mixer/wq"))
    assert all(s is None for s in specs[wq]), "20 heads must not shard over 16"
    w_in = next(k for k in specs if "ffn/w_in" in k)
    assert specs[w_in][-1] == "model"


def test_gemma3_full_head_sharding():
    specs = _specs(ARCHS["gemma3-27b"], _mesh16())
    wq = next(k for k in specs if k.endswith("mixer/wq"))
    wk = next(k for k in specs if k.endswith("mixer/wk"))
    assert specs[wq][-2] == "model"  # 32 q heads
    assert specs[wk][-2] == "model"  # 16 kv heads


def test_zero_adds_data_axis_to_large_leaves():
    specs = _specs(ARCHS["grok-1-314b"], _mesh16(), zero=True)
    w_in = next(k for k in specs if "ffn/w_in" in k)
    assert "data" in specs[w_in] and "model" in specs[w_in]
    norm = next(k for k in specs if k.startswith("final_norm"))
    assert "data" not in specs[norm]


def test_mamba_projections_shard_cleanly():
    specs = _specs(ARCHS["mamba2-2.7b"], _mesh16())
    for leaf in ("w_z", "w_x", "conv_x", "norm_scale"):
        key = next(k for k in specs if k.endswith(f"mixer/{leaf}"))
        assert "model" in specs[key], leaf


def test_decode_cache_sequence_sharding():
    cfg = ARCHS["phi3-medium-14b"]
    shape = get_shape("decode_32k")
    specs = build_model(cfg).input_specs(shape)
    tree = sh.batch_shardings(cfg, shape, _mesh16(), specs)
    k_spec = tree["caches"]["blocks"]["0"]["k"].spec
    assert k_spec[1] in ("data", ("data",))  # batch 128 over data
    assert k_spec[2] == "model"  # sequence over model (flash-decode layout)
    assert tree["caches"]["lengths"].spec == P()


# -- leaf for leaf against the reference ---------------------------------------------


@pytest.mark.parametrize("zero", [False, True], ids=["zero_off", "zero_on"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_shardings_match_reference(arch, zero):
    want = _captured(jax_sh.param_shardings, JAX_ARCHS[arch], _jax_params_sds(arch),
                     _JaxMesh16(), zero=zero)
    got = {k: tuple(v) for k, v in _specs(ARCHS[arch], _mesh16(), zero=zero).items()}
    assert got == want


@pytest.mark.parametrize("shape", [s.name for s in JAX_SHAPES])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_shardings_match_reference(arch, shape):
    jshape = next(s for s in JAX_SHAPES if s.name == shape)
    jcfg = JAX_ARCHS[arch]
    want = _captured(jax_sh.batch_shardings, jcfg, jshape, _JaxMesh16(),
                     jax_build_model(jcfg).input_specs(jshape))
    cfg, tshape = ARCHS[arch], get_shape(shape)
    tree = sh.batch_shardings(cfg, tshape, _mesh16(), build_model(cfg).input_specs(tshape))
    got = {k: tuple(s.spec) for k, s in _flatten(tree).items()}
    assert got == want


def test_shard_shape_and_multi_pod_batch_axes():
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.sizes == {"pod": 2, "data": 16, "model": 16} and mesh.size == 512
    s = sh.NamedSharding(mesh, P(("pod", "data"), None, "model"))
    assert sh.shard_shape((128, 7, 40), s) == (4, 7, 3)  # 40 / 16 rounds up
    assert sh.shard_shape((5,), sh.replicated(mesh)) == (5,)
    assert P(("data",), None) == P("data", None)
