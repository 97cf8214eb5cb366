"""PyTorch port: the shade backward (ops/shade.py phong_shade_bwd and its
plain version) against the JAX package's backward kernel
(pallas_shade._shade_bwd_kernel, in interpret mode here) and against
torch.autograd of the forward's plain version, shading.phong_core."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from openglraytracer_tpu.ops.pallas_shade import phong_fused as j_phong
from openglraytracer_tpu_torch import kernels
from openglraytracer_tpu_torch.ops import shade
from openglraytracer_tpu_torch.ops.shading import phong_core

from _torch_helpers import np_

NAMES = ("mat", "lpos", "lamb", "ldiff", "lspec", "dirs", "p", "n")


def _inputs(seed=3, r_tot=512, n_l=3):
    """Generic shade inputs and a cotangent, as the JAX package's own test
    of its backward kernel builds them (tests/test_pallas_shade.py)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mat = rng.random((r_tot, 20)).astype(f32)
    lpos = rng.normal(0, 5, (n_l, 3)).astype(f32)
    lamb, ldiff, lspec = (rng.random((n_l, 4)).astype(f32) for _ in range(3))
    dirs = rng.normal(0, 1, (r_tot, 3)).astype(f32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    p = rng.normal(0, 3, (r_tot, 3)).astype(f32)
    nrm = rng.normal(0, 1, (r_tot, 3)).astype(f32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    occ = rng.random((r_tot, n_l)) < 0.3
    g = rng.normal(0, 1, (r_tot, 3)).astype(f32)
    return (mat, lpos, lamb, ldiff, lspec, dirs, p, nrm), occ, g


def _t(xs):
    return [torch.tensor(x) for x in xs]


def test_plain_backward_matches_jax_kernel():
    """phong_shade_bwd_plain against the VJP of the JAX package's
    phong_fused, whose backward is the reference's analytic kernel: every
    cotangent at rtol 2e-5, atol 1e-6, the bound the JAX package holds that
    kernel to against its XLA replay. The light columns are summed over all
    rays here and per tile of 256 rays there."""
    args, occ, g = _inputs()
    _, vjp = jax.vjp(lambda *a: j_phong(*a, jnp.asarray(occ, jnp.float32),
                                        256), *(jnp.asarray(x) for x in args))
    ref = vjp(jnp.asarray(g))
    out = shade.phong_shade_bwd_plain(*_t(args), torch.tensor(occ),
                                      torch.tensor(g))
    for name, a, b in zip(NAMES, ref, out):
        assert b.shape == a.shape and b.dtype == torch.float32, name
        np.testing.assert_allclose(np_(b), np_(a), rtol=2e-5, atol=1e-6,
                                   err_msg=name)


def test_plain_backward_matches_autograd_of_the_forward():
    """The analytic chain against torch.autograd of phong_core (the port's
    counterpart of the JAX package's replay VJP): the same derivative up to
    rounding, at the same rtol 2e-5, atol 1e-6. Columns 17-19 of the
    material rows get no cotangent in either."""
    args, occ, g = _inputs(seed=8, r_tot=300, n_l=2)
    leaves = [x.requires_grad_() for x in _t(args)]
    out = phong_core(*leaves, torch.tensor(occ))
    ref = torch.autograd.grad(out, leaves, torch.tensor(g))
    got = shade.phong_shade_bwd_plain(*_t(args), torch.tensor(occ),
                                      torch.tensor(g))
    for name, a, b in zip(NAMES, ref, got):
        np.testing.assert_allclose(np_(b), np_(a), rtol=2e-5, atol=1e-6,
                                   err_msg=name)
    assert not got[0][:, 17:].any()


def test_phong_fused_backward_is_the_wrapper_on_cpu():
    """phong_fused is an autograd.Function: on CPU tensors its forward is
    phong_core and its backward phong_shade_bwd's plain version, exactly;
    the occlusion gets no gradient and no kernel is launched."""
    args, occ, g = _inputs(seed=4, r_tot=128, n_l=2)
    leaves = [x.requires_grad_() for x in _t(args)]
    kernels.LAUNCHES.clear()
    out = shade.phong_fused(*leaves, torch.tensor(occ))
    torch.testing.assert_close(out, phong_core(*_t(args), torch.tensor(occ)),
                               rtol=0, atol=0)
    out.backward(torch.tensor(g))
    want = shade.phong_shade_bwd_plain(*_t(args), torch.tensor(occ),
                                       torch.tensor(g))
    for name, leaf, w in zip(NAMES, leaves, want):
        assert torch.equal(leaf.grad, w), name
    assert sum(kernels.LAUNCHES.values()) == 0


def test_wrapper_dispatch_and_no_lights():
    """phong_shade_bwd runs the plain version on CPU tensors and gives
    (0, k) light cotangents when there are no lights."""
    args, occ, g = _inputs(seed=6, r_tot=64, n_l=1)
    args = list(args)
    for i in (1, 2, 3, 4):
        args[i] = args[i][:0]
    out = shade.phong_shade_bwd(*_t(args), torch.tensor(occ[:, :0]),
                                torch.tensor(g))
    assert [tuple(x.shape) for x in out[1:5]] == [(0, 3), (0, 4), (0, 4),
                                                  (0, 4)]
    # emissive only: the color is emissive rgb * alpha, so its cotangent is
    # (g * alpha, g . rgb) and the other material columns get none
    emi, gt = torch.tensor(args[0][:, 12:16]), torch.tensor(g)
    want = torch.cat([gt * emi[:, 3:], (gt * emi[:, :3]).sum(-1, True)], -1)
    torch.testing.assert_close(out[0][:, 12:16], want, rtol=1e-6, atol=1e-7)
    assert not out[0][:, :12].any() and not out[0][:, 16:].any()
