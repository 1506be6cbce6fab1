"""Parity of the port's W8A8 path (vicasplat_tpu_torch/ops/quant.py) with
the JAX package's ops/quant.py, on the CPU: the int8 weights bit for bit
and their scales, the quantized families' paths and count, the quantized
linear, and the quantized engine's reconstruct at the tiny config."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests.test_torch_model import TOL, perturbed_params, tiny_cfgs
from vicasplat_tpu import serving as jserving
from vicasplat_tpu.models.layers import linear as jlinear
from vicasplat_tpu.ops import quant as jquant
from vicasplat_tpu_torch import serving as tserving
from vicasplat_tpu_torch.models import vicasplat as tvs
from vicasplat_tpu_torch.models.layers import linear as tlinear
from vicasplat_tpu_torch.ops import quant as tquant
from vicasplat_tpu_torch.utils import weights

torch.set_num_threads(1)


def jax_quantized(tree, path=""):
    """{path: {"w_q", "w_s"}} of a quantized JAX param tree."""
    if isinstance(tree, dict):
        if "w_q" in tree:
            return {path: tree}
        return {p: v for k, x in tree.items() for p, v in jax_quantized(x, f"{path}/{k}").items()}
    return {}


def port_quantized(model):
    """{path: [QuantLinear, ...]} of a quantized port model, by family."""
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, tquant.QuantLinear):
            out.setdefault(tquant.jax_path(name), []).append(mod)
    return out


@pytest.mark.parametrize("head", ["dpt", "linear"])
@pytest.mark.parametrize("min_size,exclude", [(1, None), (1, ()), (1 << 12, None)])
def test_quantize_tree_matches_jax(head, min_size, exclude):
    """Same float weights on both sides: the same families (paths and
    count, the center head excluded by default), the int8 weights bit for
    bit, the scales within 1e-7 relative."""
    heads = dict(gs_center_head_type=head, gs_param_head_type=head)
    jcfg, tcfg = tiny_cfgs(**heads)
    params = perturbed_params(jcfg)
    excl = jquant.SENSITIVE_PATHS if exclude is None else exclude
    jq, jn = jquant.quantize_tree(params, min_size=min_size, exclude=excl)
    model = weights.load_jax_params(tvs.VicaSplat(tcfg), params)
    assert sorted(tquant.quantizable_paths(model, min_size)) == \
        sorted(jquant.quantizable_paths(params, min_size))
    model, tn = tquant.quantize_tree(model, min_size=min_size, exclude=excl)
    assert tn == jn > 0
    jfam, tfam = jax_quantized(jq), port_quantized(model)
    assert sorted(tfam) == sorted(jfam)
    if exclude is None:
        assert not any("/center_head/" in p for p in tfam)
    if head == "linear" and exclude == ():
        assert "/center_head/proj" in tfam
    for path, mods in tfam.items():
        w_q, w_s = np.asarray(jfam[path]["w_q"]), np.asarray(jfam[path]["w_s"])
        if w_q.ndim == 2:  # a flat linear: one module
            w_q, w_s = w_q[None], w_s[None]
        assert len(mods) == w_q.shape[0], path
        for i, mod in enumerate(mods):  # (d_in, d_out) -> torch's (out, in)
            np.testing.assert_array_equal(mod.w_q.numpy(), w_q[i].T, err_msg=path)
            np.testing.assert_allclose(mod.w_s.numpy(), w_s[i], rtol=1e-7, atol=0)


def test_linear_w8a8_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.05, (256, 512)).astype(np.float32)
    b = rng.normal(0, 0.1, 512).astype(np.float32)
    x = rng.normal(size=(4, 33, 256)).astype(np.float32)
    ref = jquant.linear_w8a8(jquant.quantize_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}),
                             jnp.asarray(x))
    lin = nn.Linear(256, 512)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    q = tquant.quantize_linear(lin)
    got = tquant.linear_w8a8(q, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # layers.linear dispatches on the quantized module, as JAX's on "w_q"
    np.testing.assert_array_equal(tlinear(q, torch.from_numpy(x)).numpy(), got.numpy())
    np.testing.assert_array_equal(
        np.asarray(jlinear(jquant.quantize_linear({"w": jnp.asarray(w)}), jnp.asarray(x))),
        np.asarray(jquant.linear_w8a8(jquant.quantize_linear({"w": jnp.asarray(w)}),
                                      jnp.asarray(x))))
    # the output dtype follows `dtype`, the int32 product is exact
    assert tquant.linear_w8a8(q, torch.from_numpy(x), dtype=torch.bfloat16).dtype \
        == torch.bfloat16


def test_cast_preserves_quant_dtypes():
    model = nn.Sequential(nn.Linear(128, 256), nn.LayerNorm(256))
    model, n = tquant.quantize_tree(model, min_size=1)
    assert n == 1
    tquant.cast_tree_preserving_quant(model, torch.bfloat16)
    q = model[0]
    assert q.w_q.dtype == torch.int8 and q.w_s.dtype == torch.float32
    assert q.bias.dtype == torch.bfloat16 and model[1].weight.dtype == torch.bfloat16


def test_quantized_engine_matches_jax():
    """The quantized engines (every linear, min size 1) reconstruct the
    same scene within TOL of each other, and stay near the float engine."""
    jcfg, tcfg = tiny_cfgs()
    params = perturbed_params(jcfg)
    images = np.random.default_rng(0).uniform(0, 1, (1, 3, 32, 32, 3)).astype(np.float32)
    K = np.ascontiguousarray(np.broadcast_to(
        np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], np.float32),
        (1, 3, 3, 3)))
    je = jserving.InferenceEngine(jcfg, params=params, dtype=jnp.float32,
                                  quantize=True, quantize_min_size=1)
    te = tserving.InferenceEngine(tcfg, params=params, dtype=torch.float32,
                                  quantize=True, quantize_min_size=1, device="cpu")
    assert te.n_quantized == je.n_quantized > 0
    js, ts = je.reconstruct(images, K), te.reconstruct(images, K)
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses), atol=TOL, rtol=TOL)
    for name in ("means", "opacities", "scales", "rotations", "harmonics"):
        np.testing.assert_allclose(getattr(ts.gaussians, name).numpy(),
                                   np.asarray(getattr(js.gaussians, name)),
                                   atol=TOL, rtol=TOL, err_msg=name)
    fe = tserving.InferenceEngine(tcfg, params=params, dtype=torch.float32, device="cpu")
    m_f = fe.reconstruct(images, K).gaussians.means.numpy().ravel()
    assert np.corrcoef(m_f, ts.gaussians.means.numpy().ravel())[0, 1] > 0.95


def test_engine_quantize_leaves_callers_model_float():
    _, tcfg = tiny_cfgs(gs_center_head_type="linear", gs_param_head_type="linear")
    model = tvs.init_vicasplat(tcfg, torch.Generator().manual_seed(0), "cpu")
    eng = tserving.InferenceEngine(tcfg, model=model, dtype=torch.float32,
                                   quantize=True, quantize_min_size=1, device="cpu")
    assert not port_quantized(model)
    paths = port_quantized(eng.model)
    assert paths and not any("/center_head/" in p for p in paths)
    eng_all = tserving.InferenceEngine(tcfg, model=model, dtype=torch.float32,
                                       quantize=True, quantize_min_size=1,
                                       quantize_exclude=(), device="cpu")
    assert eng_all.n_quantized == eng.n_quantized + 1


def test_jax_path_drops_block_index():
    assert tquant.jax_path("backbone.dec_blocks.11.attn.qkv") == "/backbone/dec_blocks/attn/qkv"
    assert tquant.jax_path("center_head.proj") == "/center_head/proj"
