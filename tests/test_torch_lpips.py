"""The port's LPIPS graph (vicasplat_tpu_torch/loss/lpips.py) against the JAX
package's (vicasplat_tpu/loss/lpips.py) on the CPU in float32: the same
parameters carried across (JAX's `init_random_lpips`, or a torch `lpips`
state dict converted on both sides), the distance and its gradient; the
weights file and the entry point's fallback."""
import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicasplat_tpu.loss import lpips as jlpips
from vicasplat_tpu_torch import main as tmain
from vicasplat_tpu_torch.loss import lpips as tlpips
from vicasplat_tpu_torch.utils.config import load_config

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# float32 on both sides through 13 3x3 convolutions summed in other orders
# (XLA's and oneDNN's), unit-normalized features and 5 weighted means: the
# distance within 1e-5 relative, its gradient within 1e-4 of its largest
# entry (measured 2e-7 and 2e-6)
DIST_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def params():
    jp = jlpips.init_random_lpips(jax.random.PRNGKey(0))
    return jp, tlpips.params_to_torch(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("shape", [(2, 17, 18, 3), (1, 2, 32, 32, 3)])
def test_lpips_matches_jax(params, shape):
    """Odd sizes (the max-pool drops the last row and column, as JAX's VALID
    window does) and extra leading dims."""
    jp, tp = params
    rng = np.random.default_rng(0)
    a, b = (rng.random(shape).astype(np.float32) for _ in range(2))
    want = jlpips.lpips_distance(jp, jnp.asarray(a), jnp.asarray(b))
    gw = jax.grad(lambda x: jlpips.lpips_distance(jp, x, jnp.asarray(b)))(jnp.asarray(a))
    at = torch.tensor(a, requires_grad=True)
    got = tlpips.lpips_distance(tp, at, torch.tensor(b))
    g, = torch.autograd.grad(got, at)
    assert abs(got.item() - float(want)) <= DIST_TOL * float(want)
    gw = np.asarray(gw)
    assert np.abs(g.numpy() - gw).max() <= GRAD_TOL * np.abs(gw).max()
    assert tlpips.lpips_distance(tp, at, at).item() == 0.0


def _torch_state(seed=0):
    """A torch `lpips.LPIPS(net='vgg')`-shaped state dict of random arrays."""
    rng = np.random.default_rng(seed)
    sd, c_in, slice_layers = {}, 3, ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21),
                                     (24, 26, 28))
    for k, ((c_out, _), layers) in enumerate(zip(tlpips.VGG_STAGES, slice_layers), 1):
        for i in layers:
            sd[f"net.slice{k}.{i}.weight"] = rng.normal(size=(c_out, c_in, 3, 3)).astype(
                np.float32) * 0.1
            sd[f"net.slice{k}.{i}.bias"] = rng.normal(size=c_out).astype(np.float32) * 0.1
            c_in = c_out
        sd[f"lin{k - 1}.model.1.weight"] = rng.random((1, c_out, 1, 1)).astype(np.float32)
    return sd


def test_converter_and_weights_file_match_jax(tmp_path):
    """The converter on both sides gives the same arrays; the JAX package's
    pickle of them, loaded by both `make_lpips_fn`s, gives the same
    distance."""
    sd = _torch_state()
    jp, tp = jlpips.convert_lpips_torch_state(sd), tlpips.convert_lpips_torch_state(sd)
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b)
    path = tmp_path / "lpips_vgg.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jp), f)
    rng = np.random.default_rng(1)
    a, b = (rng.random((1, 16, 16, 3)).astype(np.float32) for _ in range(2))
    want = float(jlpips.make_lpips_fn(str(path))(jnp.asarray(a), jnp.asarray(b)))
    got = tlpips.make_lpips_fn(str(path), device="cpu")(torch.tensor(a), torch.tensor(b))
    assert abs(got.item() - want) <= DIST_TOL * want


def test_make_lpips_fn_without_weights(tmp_path, capsys):
    """No weights file: both raise, unless allow_random, which backs the
    graph with a seeded random VGG (the same one for the same seed); the
    entry point then runs without LPIPS, with the JAX package's message."""
    missing = str(tmp_path / "none.pkl")
    with pytest.raises(FileNotFoundError):
        jlpips.make_lpips_fn(missing)
    with pytest.raises(FileNotFoundError, match="allow_random"):
        tlpips.make_lpips_fn(missing, device="cpu")
    x, y = torch.rand(1, 16, 16, 3), torch.rand(1, 16, 16, 3)
    f1 = tlpips.make_lpips_fn(missing, allow_random=True, seed=3, device="cpu")
    f2 = tlpips.make_lpips_fn(missing, allow_random=True, seed=3, device="cpu")
    assert f1(x, y).item() == f2(x, y).item() > 0.0
    cfg = load_config(ROOT / "configs/main.yaml", "re10k_8view", ["loss.lpips.weight=0.05"])
    assert cfg.loss.lpips is not None
    capsys.readouterr()
    assert tmain._maybe_lpips(cfg, "cpu") is None
    assert "lpips unavailable" in capsys.readouterr().out
