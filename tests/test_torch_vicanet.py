"""Parity of the port's VicaNet backbone with the JAX package's, in float32
on the CPU, from the same weights (carried across by utils/weights.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicasplat_tpu.models import vicanet as jvn
from vicasplat_tpu_torch.models import vicanet as tvn
from vicasplat_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(1)

# float32 on both sides through 2 encoder and 4 decoder blocks: the two
# frameworks sum matmuls and softmaxes in different orders, which leaves
# ~1e-6 relative per op; 1e-4 absolute on O(1) activations covers the
# accumulation with margin and still fails on any wrong index or sign
TOL = 1e-4

TINY = dict(img_size=32, patch_size=16, enc_embed_dim=64, enc_depth=2,
            enc_num_heads=4, dec_embed_dim=48, dec_depth=4, dec_num_heads=4,
            temporal_rope_theta=30.0)


def _inputs(B, T, size, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (B, T, size, size, 3)).astype(np.float32)
    K = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], np.float32)
    K = np.broadcast_to(K + rng.normal(0, 0.05, (B, T, 3, 3)), (B, T, 3, 3))
    return images, np.ascontiguousarray(K, dtype=np.float32)


def _perturb(params, seed):
    """Zero-initialized params (modulations) would hide the AdaLN split
    order; give every leaf random values."""
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [jnp.asarray(rng.normal(0, 0.2, x.shape), jnp.float32) for x in leaves]
    return jax.tree.unflatten(tree, leaves)


@pytest.mark.parametrize("use_intrin", [True, False])
def test_vicanet_matches_jax(use_intrin):
    jcfg = jvn.VicaNetConfig(use_intrinsic_embedding=use_intrin, **TINY)
    tcfg = tvn.VicaNetConfig(**dataclasses.asdict(jcfg))
    params = _perturb(jvn.init_vicanet(jax.random.PRNGKey(0), jcfg), 1)
    B, T = 2, 3
    images, K = _inputs(B, T, 32)

    ref = jvn.vicanet_forward(params, jcfg, jnp.asarray(images), jnp.asarray(K),
                              dtype=jnp.float32)
    model = load_jax_params(tvn.VicaNet(tcfg), params)
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(K),
                    dtype=torch.float32)

    _, cam_ext_j, cam_int_j, inter_j = ref
    _, cam_ext_t, cam_int_t, inter_t = out
    assert len(inter_t) == len(inter_j) == 1 + jcfg.dec_depth
    for i, (a, b) in enumerate(zip(inter_t, inter_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL,
                                   err_msg=f"intermediate {i}")
    np.testing.assert_allclose(cam_ext_t.numpy(), np.asarray(cam_ext_j),
                               atol=TOL, rtol=TOL)
    if use_intrin:
        assert cam_int_t is None and cam_int_j is None
    else:
        np.testing.assert_allclose(cam_int_t.numpy(), np.asarray(cam_int_j),
                                   atol=TOL, rtol=TOL)


def test_camera_mask_and_neighbours_match_jax():
    for T, n, full in [(3, 4, False), (4, 2, True)]:
        np.testing.assert_array_equal(
            tvn.camera_blocked_causal_mask(T, n, full).numpy(),
            np.asarray(jvn.camera_blocked_causal_mask(T, n, full)))
    rng = np.random.default_rng(2)
    for T in (2, 3, 5):
        k = rng.normal(size=(1, T, 3, 2, 4)).astype(np.float32)
        v = rng.normal(size=(1, T, 3, 2, 4)).astype(np.float32)
        kj, vj = jvn._neighbor_kv(jnp.asarray(k), jnp.asarray(v), T)
        kt, vt = tvn._neighbor_kv(torch.from_numpy(k), torch.from_numpy(v), T)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
