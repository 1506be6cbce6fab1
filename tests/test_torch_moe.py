"""Parity of the port's MoE decoder MLP (vicasplat_tpu_torch/models/moe.py)
with the JAX package's models/moe.py, in float32 on the CPU: the dispatch
and combine tensors, the routed MLP with and without overflow, its aux loss
and gradients, both dispatch forms (`moe_mlp`'s index form and
`moe_mlp_einsum`, JAX's), and a tiny MoE VicaNet through each.

Inputs are random (numpy, seeded) with no ties among router probabilities:
torch.topk and jax.lax.top_k may order ties differently."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicasplat_tpu.models import moe as jmoe
from vicasplat_tpu.models import vicanet as jvn
from vicasplat_tpu_torch.models import moe as tmoe
from vicasplat_tpu_torch.models import vicanet as tvn
from vicasplat_tpu_torch.utils.weights import load_jax_params, state_dict_from_jax

torch.set_num_threads(1)

# one routed MLP in float32: the frameworks sum the products in other
# orders, ~1e-6 relative on O(1) outputs; a wrong slot, gate or drop moves an
# output row by O(1)
TOL = 1e-5
# the combine tensor holds gates (products of probabilities and a division)
COMB_TOL = 1e-6
# gradients of a mean-square loss through the router's softmax and both
# expert products
GRAD_TOL = 1e-5
# the tiny VicaNet, as tests/test_torch_vicanet.py holds it
NET_TOL = 1e-4
# the two dispatch forms, by the name of the form
FORMS = {"index": tmoe.moe_mlp, "einsum": tmoe.moe_mlp_einsum}


def _params(dim, hidden, E, seed=0):
    rng = np.random.default_rng(seed)
    p = jmoe.moe_init(jax.random.PRNGKey(seed), dim, hidden, E)
    return jax.tree.map(
        lambda x: jnp.asarray(rng.normal(0, 0.5, x.shape), jnp.float32), p)


def _module(p, dim, hidden, E):
    mod = tmoe.MoeMlp(dim, hidden, E)
    mod.load_state_dict(state_dict_from_jax(p), strict=True)
    return mod


@pytest.mark.parametrize("top_k", [1, 2])
def test_dispatch_combine_matches_jax(top_k):
    rng = np.random.default_rng(1)
    S, E = 24, 4
    probs = rng.dirichlet(np.ones(E), S).astype(np.float32)
    for cap in (2, 5, S):  # overflow, mild overflow, none
        dj, cj = jmoe._dispatch_combine(jnp.asarray(probs), top_k, cap)
        dt, ct = tmoe._dispatch_combine(torch.from_numpy(probs), top_k, cap)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=COMB_TOL,
                                   rtol=0)


@pytest.mark.parametrize("dispatch", ["index", "einsum"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_mlp_matches_jax(dispatch, capacity_factor):
    dim, hidden, E = 16, 32, 4
    p = _params(dim, hidden, E)
    x = np.random.default_rng(2).normal(size=(3, 7, dim)).astype(np.float32)
    yj, auxj = jmoe.moe_mlp(p, jnp.asarray(x), top_k=2,
                            capacity_factor=capacity_factor, return_aux=True)
    mod = _module(p, dim, hidden, E)
    yt, auxt = FORMS[dispatch](mod, torch.from_numpy(x), top_k=2,
                               capacity_factor=capacity_factor, return_aux=True)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(auxt.detach()), float(auxj), rtol=TOL)
    if capacity_factor < 1:  # some routes dropped, so the check has teeth
        cap = tmoe.capacity(21, E, 2, capacity_factor)
        _, _, keep, _ = tmoe.route(torch.softmax(
            torch.from_numpy(x.reshape(-1, dim)) @ mod.router.weight.T, -1), 2, cap)
        assert not bool(keep.all())


def test_route_major_priority_matches_jax():
    """tests/test_moe.py:61: two tokens preferring opposite experts, one
    seat each: both primary routes seat, both secondaries drop."""
    dim, hidden, E = 8, 16, 2
    p = _params(dim, hidden, E)
    p["router"]["w"] = jnp.stack([jnp.ones(dim), -jnp.ones(dim)], axis=-1)
    x = np.stack([np.ones(dim), -np.ones(dim)]).astype(np.float32)
    yj = jmoe.moe_mlp(p, jnp.asarray(x), top_k=2, capacity_factor=0.5)
    mod = _module(p, dim, hidden, E)
    for form in FORMS.values():
        yt = form(mod, torch.from_numpy(x), top_k=2, capacity_factor=0.5)
        np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), atol=TOL)
        assert (yt.abs().sum(-1) > 1e-6).all()


def test_grads_match_jax():
    dim, hidden, E = 8, 16, 4
    p = _params(dim, hidden, E, seed=3)
    x = np.random.default_rng(4).normal(size=(10, dim)).astype(np.float32)

    def jloss(p):
        y, aux = jmoe.moe_mlp(p, jnp.asarray(x), top_k=2, capacity_factor=0.75,
                              return_aux=True)
        return (y ** 2).mean() + 0.01 * aux

    gj = state_dict_from_jax(jax.grad(jloss)(p))
    for dispatch, form in FORMS.items():
        mod = _module(p, dim, hidden, E)
        y, aux = form(mod, torch.from_numpy(x), top_k=2, capacity_factor=0.75,
                      return_aux=True)
        ((y ** 2).mean() + 0.01 * aux).backward()
        grads = dict(mod.named_parameters())
        assert set(grads) == set(gj)
        for k, v in gj.items():
            np.testing.assert_allclose(grads[k].grad.numpy(), v.numpy(),
                                       atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"{dispatch} {k}")
        assert grads["router.weight"].grad.abs().max() > 0


def test_index_form_equals_einsum_form():
    dim, hidden, E = 12, 24, 8
    p = _params(dim, hidden, E, seed=5)
    mod = _module(p, dim, hidden, E)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(40, dim))
                         .astype(np.float32))
    for k, cf in [(1, 1.0), (2, 1.25), (2, 0.5), (3, 0.3)]:
        a = tmoe.moe_mlp(mod, x, top_k=k, capacity_factor=cf)
        b = tmoe.moe_mlp_einsum(mod, x, top_k=k, capacity_factor=cf)
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=TOL, rtol=TOL)


def test_sharded_module_needs_its_group():
    mod = tmoe.MoeMlp(8, 16, 4)
    mod.experts.fc1.w = torch.nn.Parameter(mod.experts.fc1.w[:2])
    with pytest.raises(ValueError, match="ep_group"):
        tmoe.moe_mlp(mod, torch.zeros(3, 8))


TINY_MOE = dict(img_size=32, patch_size=16, enc_embed_dim=64, enc_depth=2,
                enc_num_heads=4, dec_embed_dim=48, dec_depth=2, dec_num_heads=4,
                use_flash_attention=False, moe_experts=4, moe_top_k=2)


def _perturb(params, seed):
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [jnp.asarray(rng.normal(0, 0.2, x.shape),
                                                 jnp.float32) for x in leaves])


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_vicanet_matches_jax(capacity_factor):
    """tests/test_moe.py:122's tiny MoE backbone, its outputs and aux."""
    jcfg = jvn.VicaNetConfig(moe_capacity_factor=capacity_factor, **TINY_MOE)
    tcfg = tvn.VicaNetConfig(**dataclasses.asdict(jcfg))
    params = _perturb(jvn.init_vicanet(jax.random.PRNGKey(0), jcfg), 7)
    rng = np.random.default_rng(8)
    images = rng.uniform(-1, 1, (2, 2, 32, 32, 3)).astype(np.float32)
    K = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 2, 3, 3)).copy()
    ref = jvn.vicanet_forward(params, jcfg, jnp.asarray(images), jnp.asarray(K),
                              dtype=jnp.float32, return_moe_aux=True)
    model = load_jax_params(tvn.VicaNet(tcfg), params)
    assert model.dec_blocks[0].mlp.experts.fc1.w.shape == (4, 48, 192)
    for dispatch, form in FORMS.items():
        with torch.no_grad(), mock.patch.object(tvn, "moe_mlp", form):
            out = model(torch.from_numpy(images), torch.from_numpy(K),
                        dtype=torch.float32, return_moe_aux=True)
        for i, (a, b) in enumerate(zip(out[3], ref[3])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=NET_TOL,
                                       rtol=NET_TOL, err_msg=f"{dispatch} {i}")
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                                   atol=NET_TOL, rtol=NET_TOL)
        np.testing.assert_allclose(float(out[4]), float(ref[4]), rtol=NET_TOL)
