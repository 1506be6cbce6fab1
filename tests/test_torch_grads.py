"""Gradients of the port's forward and render against jax.grad, in float32
on the CPU: `vicasplat_forward` to every parameter of the tiny model (DPT
heads; a linear centre head with a stabilized DPT-GS head), and the render
to the packed covariances and the harmonics on the matmul path and on the
Pallas path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import tiny_cfgs, tiny_context
from test_torch_render import SMALL, _both
from test_torch_training import _leaf, numpy_params

from vicasplat_tpu.models import vicasplat as jvs
from vicasplat_tpu.ops.rasterize.render import render as jrender
from vicasplat_tpu_torch.models import vicasplat as tvs
from vicasplat_tpu_torch.ops.rasterize.render import render as trender
from vicasplat_tpu_torch.utils import weights

torch.set_num_threads(1)

# float32 on both sides: the backbone, ~20 convs of the DPT heads and the
# exp map, forward and backward, each op summed in another order, and the
# trunk's random weights grow its activations level by level, and the
# stabilized trunk's channel LayerNorm divides by each pixel's channel std;
# each gradient within 1e-3 of its tensor's largest entry (the worst seen,
# 5.1e-4, is in the stabilized centre head's first scratch conv)
MODEL_GRAD_TOL = 1e-3
# the render's gradients, as tests/test_torch_render.py holds them: the
# same recompute through matmul compositing on both sides, summed in other
# orders over ~100 splats a pixel, relative to the largest entry
RENDER_GRAD_TOL = 1e-3


@pytest.mark.parametrize("heads", [
    dict(),
    dict(dpt_stabilize=True, gs_center_head_type="linear")])
def test_forward_grads_match_jax(heads):
    jcfg, tcfg = tiny_cfgs(T=2, **heads)
    params = numpy_params(jcfg)
    images, K = tiny_context(B=1, T=2)
    rng = np.random.default_rng(8)
    w_raw = rng.normal(size=(1, 2, 32, 32, jcfg.gaussian_adapter.raw_gs_dim + 3))
    w_cam = rng.normal(size=(1, 1, 8))
    w_raw, w_cam = (x.astype(np.float32) for x in (w_raw, w_cam))

    def jloss(p):
        out = jvs.vicasplat_forward(p, jcfg, {"image": jnp.asarray(images),
                                              "intrinsics": jnp.asarray(K)},
                                    dtype=jnp.float32)
        return ((out["raw_gaussians"] * w_raw).sum()
                + (out["pred_extrins"] * w_cam).sum())

    jg = jax.jit(jax.grad(jloss))(params)
    model = weights.load_jax_params(tvs.VicaSplat(tcfg), params)
    out = tvs.vicasplat_forward(model, {"image": torch.from_numpy(images),
                                        "intrinsics": torch.from_numpy(K)},
                                dtype=torch.float32)
    ((out["raw_gaussians"] * torch.from_numpy(w_raw)).sum()
     + (out["pred_extrins"] * torch.from_numpy(w_cam)).sum()).backward()
    got = weights.jax_tree_from_state_dict(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in model.named_parameters()}, params)
    for path, j in jax.tree_util.tree_flatten_with_path(jg)[0]:
        j = np.asarray(j)
        np.testing.assert_allclose(_leaf(got, path), j, rtol=0,
                                   atol=MODEL_GRAD_TOL * np.abs(j).max() + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("raster", [dict(SMALL),
                                    dict(SMALL, backend="pallas", binning="origin")])
def test_render_grads_to_cov6_and_harmonics_match_jax(raster):
    """The matmul compositing path, and the Pallas path (K2's autograd
    function with origin binning; the JAX Pallas kernel interpreted)."""
    image_shape = (32, 32)
    bg = np.zeros(3, np.float32)
    jargs, targs, cov6, jcfg, tcfg = _both(raster, image_shape, bg, n=200)

    def jloss(c6, sh):
        c, d, a = jrender(jargs[0], None, sh, *jargs[3:], image_shape,
                          tuple(bg.tolist()), 2, cfg=jcfg, cov6=c6)
        return (c ** 2).sum() + 1e-2 * d.sum() + a.sum()

    gj = jax.grad(jloss, argnums=(0, 1))(cov6, jargs[2])
    leaves = [targs[1].clone().requires_grad_(), targs[2].clone().requires_grad_()]
    c, d, a = trender(targs[0], leaves[0], leaves[1], *targs[3:], image_shape,
                      torch.from_numpy(bg), 2, cfg=tcfg)
    ((c ** 2).sum() + 1e-2 * d.sum() + a.sum()).backward()
    for name, t, j in zip(("cov6", "harmonics"), leaves, gj):
        j = np.asarray(j)
        assert np.abs(j).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=0,
                                   atol=RENDER_GRAD_TOL * np.abs(j).max(),
                                   err_msg=name)
