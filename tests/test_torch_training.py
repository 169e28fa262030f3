"""The port's training substrate against the reference's.

Gradients: ``jax.value_and_grad`` of the reference's ``apply_plan`` (XLA
path) and torch autograd through the port's plain versions, on an
n337-shaped net at 4 maps, the same numpy params and input in both.
The hand-written backward (``Conv3dFn``, ``MpfPoolFn``) runs here on its
CPU route, checked by ``gradcheck`` in float64, and the CUDA backward
kernels' decompositions, replayed in plain PyTorch
(``ref.conv3d_wgrad_chunked``, ``ref.mpf_pool_bwd_gather``), against the
reference's gradients; the kernels themselves are held against the plain
versions on the card (``chip_smoke.py``'s train phase).  Then AdamW, the
schedule, the data pipeline and checkpoints.

Tolerances, each with its reason:
- gradients: ``|g_port - g_ref| <= 1e-4 * max|g_ref| + 1e-6`` per tensor;
  the two frameworks sum the convs' products in different orders, and a
  tensor's small entries are sums that cancel, so the scale is the
  tensor's largest entry;
- AdamW: 1e-6 relative on params and float moments (``pow`` of the bias
  corrections may round differently); int8 payloads and bf16 moments are
  compared exactly (the moments are products and sums of the same float32
  values in both packages, with the gradient norm kept below the clip so
  the clip factor is exactly 1);
- data, checkpoints and a resumed run: bitwise.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ConvLayerSpec as JL
from repro.configs.base import ConvNetConfig as JC
from repro.core import convnet as jconvnet
from repro.data import SyntheticVolumePipeline as JPipe
from repro.data import TokenPipelineConfig as JTokCfg
from repro.data import SyntheticTokenPipeline as JTokPipe
from repro.data import VolumePipelineConfig as JVolCfg
from repro.kernels.direct_conv3d import ops as jax_conv3d
from repro.kernels.mpf_pool import ops as jax_mpf
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import apply_updates as j_apply_updates
from repro.optim import cosine_warmup as j_cosine_warmup
from repro.optim import init_state as j_init_state
from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import ConvLayerSpec as L
from repro_torch.configs.base import ConvNetConfig as C
from repro_torch.core import convnet
from repro_torch.data import (
    SyntheticTokenPipeline,
    SyntheticVolumePipeline,
    TokenPipelineConfig,
    VolumePipelineConfig,
)
from repro_torch.examples.train_segmentation import SEG_NET, bce, labels_of, train_step
from repro_torch.kernels import dispatch
from repro_torch.kernels.cmul_mad import ops as cmul_ops
from repro_torch.kernels.decode_attn import ops as da_ops
from repro_torch.kernels.direct_conv3d import ops as conv_ops
from repro_torch.kernels.direct_conv3d import ref as conv_ref
from repro_torch.kernels.mpf_pool import ops as pool_ops
from repro_torch.kernels.mpf_pool import ref as pool_ref
from repro_torch.kernels.os_segment import ops as os_ops
from repro_torch.optim import (
    AdamWConfig,
    QTensor,
    adamw_state_from_numpy,
    apply_updates,
    cosine_warmup,
    init_state,
    tree,
)

# n337's layer kinds and kernel sizes (configs/znni_nets.py) at 4 maps
N337_4 = (("conv", 2, 4), ("pool", 2), ("conv", 3, 4), ("pool", 2), ("conv", 3, 4),
          ("pool", 2), ("conv", 3, 4), ("conv", 3, 4), ("conv", 3, 4), ("conv", 3, 3))
PRIMS = ["direct" if kind == "conv" else "mpf" for kind, *_ in N337_4]


def np_params(layers, in_ch, seed):
    """He-scaled conv weights and nonzero biases as numpy, None at pools."""
    rng = np.random.default_rng(seed)
    params, f = [], in_ch
    for kind, k, *rest in layers:
        if kind != "conv":
            params.append(None)
            continue
        fp = rest[0]
        w = rng.normal(size=(fp, f, k, k, k)) * np.sqrt(2.0 / (f * k**3))
        b = 0.1 * rng.normal(size=(fp,))
        params.append((w.astype(np.float32), b.astype(np.float32)))
        f = fp
    return params


def _jparams(np_p):
    return [None if p is None else (jnp.asarray(p[0]), jnp.asarray(p[1])) for p in np_p]


def _close_to_max(got, want, rtol=1e-4, atol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = rtol * np.abs(want).max() + atol
    err = np.abs(got - want).max()
    assert err <= bound, f"max err {err:.3e} above {bound:.3e}"


# -- gradients through the whole net --------------------------------------------------


def test_n337_shaped_gradients_match_reference():
    net = C("n337-4", 1, tuple(L(*l) for l in N337_4))
    jnet = JC("n337-4", 1, tuple(JL(*l) for l in N337_4))
    np_p = np_params(N337_4, 1, 0)
    n_in = net.valid_input_size(1)
    x = np.random.default_rng(1).normal(size=(1, 1, n_in, n_in, n_in)).astype(np.float32)
    n_out = n_in - net.field_of_view() + 1
    y = (np.random.default_rng(2).random((1, 3, n_out, n_out, n_out)) > 0.5).astype(np.float32)

    def jloss(p):
        z = jconvnet.apply_plan(p, jnet, jnp.asarray(x), PRIMS, use_pallas=False)
        return jnp.mean(jnp.maximum(z, 0) - z * y + jnp.log1p(jnp.exp(-jnp.abs(z))))

    jl, jg = jax.value_and_grad(jloss)(_jparams(np_p))
    params = convnet.params_from_numpy(np_p, device="cpu")
    leaves = [t.requires_grad_(True) for t in tree.leaves(params)]
    loss = bce(convnet.apply_plan(tree.unflatten(params, leaves), net,
                                  torch.from_numpy(x), PRIMS), torch.from_numpy(y))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads) == 14  # a (w, b) for each of the 7 convs
    for g, jgl in zip(grads, jleaves):
        assert g is not None and g.shape == jgl.shape
        _close_to_max(g.numpy(), np.asarray(jgl))


# -- the hand-written backward on its CPU route -------------------------------------


def test_conv3d_fn_gradcheck():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 6, 5, 7), generator=gen, dtype=torch.float64, requires_grad=True)
    w = torch.randn((4, 3, 3, 2, 3), generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: conv_ops.Conv3dFn.apply(a, b, False), (x, w))


def test_mpf_pool_fn_gradcheck():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 2, 5, 5, 3), generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: pool_ops.MpfPoolFn.apply(a, 2, False), (x,))


@pytest.mark.parametrize("which", ["dgrad", "wgrad"])
def test_plain_conv3d_gradients_gradcheck(which):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 3, 5, 6, 4), generator=gen, dtype=torch.float64, requires_grad=True)
    g = torch.randn((2, 4, 3, 5, 2), generator=gen, dtype=torch.float64, requires_grad=True)
    w = torch.randn((4, 3, 3, 2, 3), generator=gen, dtype=torch.float64, requires_grad=True)
    if which == "dgrad":
        assert torch.autograd.gradcheck(conv_ref.conv3d_dgrad, (g, w))
    else:
        assert torch.autograd.gradcheck(lambda a, b: conv_ref.conv3d_wgrad(a, b, (3, 2, 3)),
                                        (x, g))


def test_plain_mpf_pool_bwd_gradcheck():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((1, 2, 5, 3, 5), generator=gen, dtype=torch.float64)
    gy = torch.randn((8, 2, 2, 1, 2), generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda g: pool_ref.mpf_pool_bwd(x, g, 2), (gy,))


@pytest.mark.parametrize("k", [(2, 2, 2), (3, 3, 3), (3, 2, 4)])
def test_plain_conv3d_gradients_are_autograds(k):
    """``conv3d_dgrad``/``conv3d_wgrad`` equal autograd of ``conv3d``."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 3, 7, 6, 8), generator=gen, requires_grad=True)
    w = torch.randn((5, 3) + k, generator=gen, requires_grad=True)
    out = conv_ref.conv3d(x, w)
    g = torch.randn(out.shape, generator=gen)
    dx, dw = torch.autograd.grad(out, (x, w), g)
    torch.testing.assert_close(conv_ref.conv3d_dgrad(g, w.detach()), dx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(conv_ref.conv3d_wgrad(x.detach(), g, k), dw, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p,n", [(2, (7, 9, 5)), (3, (8, 5, 11))])
def test_plain_mpf_pool_bwd_is_autograd_without_ties(p, n):
    """Tie-free inputs: a random permutation, so every window's maximum is
    unique and ``argmax`` and ``amax``'s even split agree."""
    gen = torch.Generator().manual_seed(4)
    numel = 2 * 3 * n[0] * n[1] * n[2]
    x = (torch.randperm(numel, generator=gen).to(torch.float32) / numel).reshape((2, 3) + n)
    xg = x.clone().requires_grad_(True)
    y = pool_ref.mpf_pool(xg, p)
    gy = torch.randn(y.shape, generator=gen)
    (gx,) = torch.autograd.grad(y, xg, gy)
    torch.testing.assert_close(pool_ref.mpf_pool_bwd(x, gy, p), gx, rtol=1e-6, atol=1e-6)


def test_mpf_pool_bwd_takes_the_first_maximum():
    """A window of equal values: its whole gradient goes to its first tap."""
    x = torch.zeros((1, 1, 3, 3, 3))
    gy = torch.arange(1, 9, dtype=torch.float32).reshape(8, 1, 1, 1, 1)
    gx = pool_ref.mpf_pool_bwd(x, gy, 2)
    # fragment o's only window starts at o = (ox, oy, oz)
    want = torch.zeros_like(x)
    for o, (ox, oy, oz) in enumerate(itertools.product(range(2), repeat=3)):
        want[0, 0, ox, oy, oz] += gy[o, 0, 0, 0, 0]
    assert torch.equal(gx, want)


# -- the backward kernels' structure, replayed on the CPU ----------------------------


@pytest.mark.parametrize("S,f,fp,n,k,sms", [
    (2, 1, 9, (9, 8, 11), (2, 2, 2), 2),     # f = 1, as n337's layer 0
    (3, 6, 3, (6, 7, 12), (3, 3, 3), 2),     # f' = 3, as its last layer
    (2, 5, 7, (5, 9, 13), (3, 2, 4), 1),     # anisotropic k: two dz groups
    (1, 3, 4, (12, 12, 12), (9, 9, 9), 3),   # n926's k: 243 tap groups
    (1, 24, 24, (5, 19, 9), (3, 3, 3), 2),   # 2 x 2 channel tiles, 3 row tiles
])
def test_conv3d_wgrad_chunked_matches_reference(S, f, fp, n, k, sms):
    """``conv3d_wgrad.cu``'s chunks, channel tiles and zero padding, replayed,
    give the reference's weight gradient (``jax.vjp`` of its ``conv3d``, XLA
    path) at its conv tolerance, ``atol=1e-3, rtol=1e-4``."""
    rng = np.random.default_rng(7 * S + f + fp)
    x = rng.normal(size=(S, f) + n).astype(np.float32)
    w = rng.normal(size=(fp, f) + k).astype(np.float32)
    npn = tuple(a - b + 1 for a, b in zip(n, k))
    g = rng.normal(size=(S, fp) + npn).astype(np.float32)
    _, vjp = jax.vjp(lambda ww: jax_conv3d.conv3d(jnp.asarray(x), ww, use_pallas=False),
                     jnp.asarray(w))
    (want,) = vjp(jnp.asarray(g))
    assert conv_ref.wgrad_plan(S, f, fp, k, npn, sms)["C"] > 1
    got = conv_ref.conv3d_wgrad_chunked(torch.from_numpy(x), torch.from_numpy(g), k, sms=sms)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("p,n", [(2, (7, 9, 5)), (2, (3, 5, 3)), (3, (8, 5, 11))])
def test_mpf_pool_bwd_gather_matches_reference(p, n):
    """The gradient kernel's gather, replayed: bitwise equal to the plain
    version, and on tie-free inputs equal to the reference's gradient
    (``jax.vjp`` of its ``mpf_pool``, XLA path) up to the order of a
    voxel's few sums (``rtol=1e-6``)."""
    numel = 2 * 3 * n[0] * n[1] * n[2]
    x = (np.random.default_rng(p).permutation(numel).astype(np.float32) / numel).reshape(
        (2, 3) + n)
    y, vjp = jax.vjp(lambda xx: jax_mpf.mpf_pool(xx, p, use_pallas=False), jnp.asarray(x))
    gy = np.random.default_rng(p + 1).normal(size=y.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(gy))
    got = pool_ref.mpf_pool_bwd_gather(torch.from_numpy(x), torch.from_numpy(gy), p)
    assert torch.equal(got, pool_ref.mpf_pool_bwd(torch.from_numpy(x), torch.from_numpy(gy), p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# -- no backward, no silent partial gradient ----------------------------------------


def test_check_no_grad():
    t = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        dispatch.check_no_grad("k", None, t)
    dispatch.check_no_grad("k", t.detach())
    with torch.no_grad():
        dispatch.check_no_grad("k", t)


def _call_kernel_path(name):
    """Each kernel without a backward, on its kernel path, with an operand
    requiring grad (a CPU tensor: the guard comes before the operand
    checks, so it is what raises)."""
    r = torch.zeros((1, 2, 3, 3, 3), requires_grad=True)
    c = torch.zeros((1, 2, 3, 3, 2), dtype=torch.complex64)
    if name == "cmul_mad":
        return cmul_ops.cmul_mad(c.requires_grad_(True), c, use_kernels=None)
    if name == "cmul_mad_bias":
        return cmul_ops.cmul_mad_bias(c, c, torch.zeros(1, requires_grad=True),
                                      fft_shape=(3, 3, 2), use_kernels=None)
    if name == "mpf_pool_window":
        return pool_ops.mpf_pool_window(r, 2, (3, 3, 3), use_kernels=None)
    if name == "decode_attn":
        q = torch.zeros((1, 2, 8), requires_grad=True)
        kv = torch.zeros((1, 4, 1, 8))
        return da_ops.decode_attn(q, kv, kv, torch.tensor([4]), use_kernels=None)
    spec = type("Spec", (), {"n": (3, 3, 3), "n_segments": 1, "out": (3, 3, 3)})()
    if name == "os_segment":
        return os_ops.os_segment_fused(c.requires_grad_(True), c, None, spec, use_kernels=None)
    return os_ops.os_segment_conv(r, c, None, spec, use_kernels=None)


@pytest.mark.parametrize("name", ["cmul_mad", "cmul_mad_bias", "mpf_pool_window",
                                  "decode_attn", "os_segment", "os_segment_conv"])
def test_kernels_without_backward_refuse_grad(name, monkeypatch):
    for mod in (cmul_ops, pool_ops, da_ops, os_ops):
        monkeypatch.setattr(mod, "resolve_use_kernels", lambda *a: True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        _call_kernel_path(name)


def test_kernel_gradient_wrappers_refuse_cpu_tensors():
    x = torch.zeros((1, 1, 4, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        conv_ops.conv3d_wgrad(x, torch.zeros((1, 2, 3, 3, 3)), (2, 2, 2), use_kernels=True)
    with pytest.raises(ValueError, match="CUDA"):
        conv_ops.conv3d_dgrad(torch.zeros((1, 2, 3, 3, 3)), torch.zeros((2, 1, 2, 2, 2)),
                              use_kernels=True)
    x = torch.zeros((1, 1, 3, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        pool_ops.mpf_pool_bwd(x, torch.zeros((8, 1, 1, 1, 1)), 2, use_kernels=True)


# -- AdamW and the schedule --------------------------------------------------------


def _adam_tree(seed):
    """A params tree shaped like the 4-map net's: (w, b) pairs and Nones."""
    return np_params(N337_4, 1, seed)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_three_steps_match_reference(state_dtype):
    np_p = _adam_tree(0)
    rng = np.random.default_rng(5)
    # small gradients: the global norm stays below the clip
    grads = [[None if p is None else tuple(1e-3 * rng.normal(size=a.shape).astype(np.float32)
                                           for a in p) for p in np_p] for _ in range(3)]
    jcfg = JAdamWConfig(lr=1e-2, state_dtype=state_dtype)
    cfg = AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    jp, js = _jparams(np_p), j_init_state(_jparams(np_p), jcfg)
    p = convnet.params_from_numpy(np_p, device="cpu")
    s = init_state(p, cfg)
    for g in grads:
        jp, js = j_apply_updates(jp, _jparams(g), js, jcfg)
        p, s = apply_updates(p, convnet.params_from_numpy(g, device="cpu"), s, cfg)
    for a, b in zip(tree.leaves(p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    assert int(s["step"]) == int(js["step"]) == 3
    for key in ("m", "v"):
        got = tree.leaves(s[key])
        want = jax.tree.leaves(js[key])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            b = np.asarray(b)
            if state_dtype == "bfloat16":
                assert a.dtype == torch.bfloat16
                np.testing.assert_array_equal(a.to(torch.float32).numpy(), b.astype(np.float32))
            elif a.dtype == torch.int8:
                np.testing.assert_array_equal(a.numpy(), b)
            else:
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=0)
    # the reference's state carried across is the port's
    back = adamw_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    for a, b in zip(tree.leaves(back), tree.leaves(s)):
        assert a.dtype == b.dtype
        if a.dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
        else:
            assert torch.equal(a, b)


def test_cosine_warmup_matches_reference():
    steps = np.arange(0, 120, dtype=np.int32)
    want = np.asarray(j_cosine_warmup(jnp.asarray(steps), peak=3e-4, warmup=10, total=100))
    got = cosine_warmup(torch.from_numpy(steps), peak=3e-4, warmup=10, total=100).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


# -- data ----------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 7, 123])
def test_batch_at_is_the_references(step):
    cfg = dict(patch=12, channels=2, batch=3, seed=4)
    a = SyntheticVolumePipeline(VolumePipelineConfig(**cfg)).batch_at(step)
    b = JPipe(JVolCfg(**cfg)).batch_at(step)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    tcfg = dict(vocab=97, seq_len=16, global_batch=4, n_hosts=2, host_id=1, seed=3)
    ta = SyntheticTokenPipeline(TokenPipelineConfig(**tcfg)).batch_at(step)
    tb = JTokPipe(JTokCfg(**tcfg)).batch_at(step)
    for k in ("tokens", "labels"):
        assert np.array_equal(ta[k], tb[k])


# -- checkpoints -------------------------------------------------------------------


def _state_tree():
    gen = torch.Generator().manual_seed(6)
    params = [(torch.randn((4, 2, 3, 3, 3), generator=gen), torch.randn(4, generator=gen)),
              None, (torch.randn((3, 4, 2, 2, 2), generator=gen), torch.randn(3, generator=gen))]
    opt8 = init_state(params, AdamWConfig(state_dtype="int8"))
    opt8["m"] = tree.tree_map(lambda t: QTensor(t.q + 3, t.scale * 2), opt8["m"],
                              is_leaf=lambda t: isinstance(t, QTensor))
    return {"params": params, "bf16": [p[0].to(torch.bfloat16) if p else None for p in params],
            "opt": opt8}


def test_checkpoint_roundtrip_is_bitwise(tmp_path):
    t = _state_tree()
    for step in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), step, t)
    th = ckpt.save(str(tmp_path), 5, t, async_=True)
    th.join()
    assert ckpt.latest_step(str(tmp_path)) == 5
    ckpt.prune_old(str(tmp_path), keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000004", "step_00000005"]
    like = tree.tree_map(torch.zeros_like, t)
    back = ckpt.restore(str(tmp_path), 5, like, device="cpu")
    assert back["params"][1] is None and back["bf16"][1] is None
    assert isinstance(back["opt"]["m"][0][0], QTensor)
    for a, b in zip(tree.leaves(back), tree.leaves(t)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 5, {"params": t["params"]}, device="cpu")


def test_resume_from_checkpoint_is_bitwise(tmp_path):
    """Five seg-net steps on the CPU, against three, a checkpoint, a
    restore into fresh objects and two more."""
    net, prims = SEG_NET, ["direct"] * 3
    fov = net.field_of_view()
    cfg = AdamWConfig(lr=1e-3)
    pipe = SyntheticVolumePipeline(VolumePipelineConfig(patch=12, batch=2))

    def batch(s):
        x = torch.from_numpy(pipe.batch_at(s))
        return x, labels_of(x, fov, 12 - fov + 1)

    params = convnet.init_params(net, torch.Generator().manual_seed(0), device="cpu")
    opt = init_state(params, cfg)
    losses = []
    for s in range(5):
        params, opt, loss, _ = train_step(params, opt, net, prims, *batch(s), cfg)
        losses.append(loss)
        if s == 2:
            th = ckpt.save(str(tmp_path), 3, {"params": params, "opt": opt}, async_=True)
    th.join()
    fresh = convnet.init_params(net, torch.Generator().manual_seed(9), device="cpu")
    like = {"params": fresh, "opt": init_state(fresh, cfg)}
    back = ckpt.restore(str(tmp_path), 3, like, device="cpu")
    p2, o2 = back["params"], back["opt"]
    for s in (3, 4):
        p2, o2, loss, _ = train_step(p2, o2, net, prims, *batch(s), cfg)
        assert torch.equal(loss, losses[s])
    for a, b in zip(tree.leaves(p2), tree.leaves(params)):
        assert torch.equal(a, b)
    for a, b in zip(tree.leaves(o2), tree.leaves(opt)):
        assert torch.equal(a, b)
