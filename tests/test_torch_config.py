"""The port's configuration (vicasplat_tpu_torch/utils/config.py and its YAML
reader) and checkpoint loading (utils/checkpointing.py) against the JAX
package: PyYAML's results on every file of configs/ and on README's
override strings, the same RootConfig for every experiment, and the
committed synthetic_pose weights in the JAX tree's leaf order, through one
float32 forward on both sides."""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vicasplat_tpu.models import init_vicasplat as jinit
from vicasplat_tpu.models import vicasplat_forward as jforward
from vicasplat_tpu.utils.config import load_config as jload_config
from vicasplat_tpu_torch.models import init_vicasplat, vicasplat_forward
from vicasplat_tpu_torch.utils import checkpointing
from vicasplat_tpu_torch.utils.config import load_config, parse_cli
from vicasplat_tpu_torch.utils.yaml_subset import YamlSubsetError, safe_load

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAIN = ROOT / "configs" / "main.yaml"
NPZ = ROOT / "outputs/synthetic_pose/ckpt_committed/weights_latest.npz"
YAMLS = sorted((ROOT / "configs").rglob("*.yaml"))
EXPERIMENTS = sorted(p.stem for p in (ROOT / "configs" / "experiment").glob("*.yaml"))
# values given on the command line in README's usage and the test-mode runs
OVERRIDES = [
    "{name: evaluation, index_path: assets/evaluation_index_re10k_8v.json, "
    "num_context_views: 8}",
    "checkpoints/re10k_8view.ckpt", "test", "4096", "true", "false", "null", "~", "",
    "1e-4", "2e-4", "1.5e-4", "0.005", "-3", "+7", "1_000", ".5", "1.", ".inf", "-.inf",
    "yes", "Off", "[2, 2]", "[gaussian_param_head, intrinsic_encoder]",
    "'quoted: string'", '"double \\"quoted\\""', "'it''s'", "[]", "{}",
    "{a: [1, {b: c}], d: 'e, f'}", "outputs/synthetic_pose/eval # a comment",
    "[1,\n 2]",
]
OUTSIDE = ["- a\n- b", "&anchor 1", "*alias", "!!str 1", "|\n  text", "0x1F", "017",
           "0b101", "1:30", "2001-12-14", "a: |\n  text", "---\na: 1", "a:\n  - 1"]


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: p.name)
def test_yaml_reader_matches_pyyaml_on_configs(path):
    text = path.read_text()
    assert safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", OVERRIDES)
def test_yaml_reader_matches_pyyaml_on_values(text):
    got, want = safe_load(text), yaml.safe_load(text)
    assert got == want or (got != got and want != want)  # NaN equals NaN here
    assert type(got) is type(want)


@pytest.mark.parametrize("text", OUTSIDE)
def test_yaml_reader_raises_outside_its_subset(text):
    with pytest.raises(YamlSubsetError):
        safe_load(text)


@pytest.mark.parametrize("experiment", [None, *EXPERIMENTS])
def test_root_config_matches_jax(experiment):
    """Every field of RootConfig, nested dataclasses and the dataset and
    loader dicts included, with an override of each kind."""
    ov = ["mode=test", "dataset.synthetic.n_scenes=4096", f"checkpointing.load={NPZ}",
          "optimizer.lr=1e-4", "test.pose_align_steps=3",
          "decoder.rasterize.backend=pallas", "decoder.rasterize.dup_hw=[3, 3]",
          "dataset.re10k.view_sampler={name: evaluation, index_path: i.json, "
          "num_context_views: 8}"]
    got = dataclasses.asdict(load_config(MAIN, experiment, ov))
    want = dataclasses.asdict(jload_config(MAIN, experiment, ov))
    assert got == want


def test_parse_cli_and_unknown_keys():
    cfg = parse_cli(["+experiment=synthetic_pose", "mode=test", "test.output_path=x",
                     "dataset.synthetic.n_scenes=4096"])
    assert cfg.mode == "test" and cfg.test.output_path == "x"
    assert cfg.dataset["synthetic"]["n_scenes"] == 4096
    assert cfg.encoder.backbone.img_size == 64 and cfg.decoder.rasterize.max_per_tile == 256
    with pytest.raises(KeyError, match="unknown config key"):
        parse_cli(["test.no_such_key=1"])


def _pose_cfgs():
    return (jload_config(MAIN, "synthetic_pose").encoder,
            load_config(MAIN, "synthetic_pose").encoder)


@pytest.mark.parametrize("experiment", ["synthetic_pose", None, "_tiny_smoke"])
def test_npz_leaf_order_matches_jax_tree(experiment):
    """`jax_leaf_specs` gives the paths and shapes of
    jax.tree_util.tree_leaves(init_vicasplat(...)), in that order."""
    jcfg = jload_config(MAIN, experiment).encoder
    tcfg = load_config(MAIN, experiment).encoder
    shapes = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    want = [([k.key for k in path], tuple(x.shape))
            for path, x in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    if experiment is None:  # the flagship's 578M parameters: shapes only
        with torch.device("meta"):
            from vicasplat_tpu_torch.models.vicasplat import VicaSplat
            model = VicaSplat(tcfg)
    else:
        model = init_vicasplat(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert checkpointing.jax_leaf_specs(model) == want


def test_load_weights_matches_pose_segments_restore():
    """The committed npz loads into the port (66 leaves, strict) and gives
    the same float32 tensors as the JAX package's restore
    (tools/pose_segments.py:load_committed), crossed by the weight bridge;
    one float32 forward of 4 frames of 64^2 agrees on both sides."""
    from vicasplat_tpu_torch.utils.weights import state_dict_from_jax

    jcfg, tcfg = _pose_cfgs()
    template = jinit(jax.random.PRNGKey(0), jcfg)
    leaves, treedef = jax.tree_util.tree_flatten(template)
    with np.load(NPZ) as z:
        assert sum(k.startswith("arr_") for k in z.files) == len(leaves) == 66
        params = jax.tree_util.tree_unflatten(
            treedef, [z[f"arr_{i}"].astype(np.float32) for i in range(len(leaves))])
    model = init_vicasplat(tcfg, torch.Generator().manual_seed(1), "cpu")
    meta = checkpointing.load_weights(NPZ, model)
    assert meta == {"total_steps": 96000, "segment": 7}
    want = state_dict_from_jax(params)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)

    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (1, 4, 64, 64, 3)).astype(np.float32)
    K = np.broadcast_to(np.array([[0.87, 0, 0.5], [0, 0.87, 0.5], [0, 0, 1]],
                                 np.float32), (1, 4, 3, 3)).copy()
    jout = jforward(params, jcfg, {"image": jnp.asarray(images), "intrinsics": jnp.asarray(K)},
                    dtype=jnp.float32)
    with torch.no_grad():
        tout = vicasplat_forward(model, {"image": torch.from_numpy(images),
                                         "intrinsics": torch.from_numpy(K)},
                                 dtype=torch.float32)
    # float32 on both sides through 10 blocks, the linear heads and the exp
    # map of the means, summed in other orders: relative to each output's
    # largest entry
    for name, a, b in (("means", tout["gaussians"].means, jout["gaussians"].means),
                       ("opacities", tout["gaussians"].opacities,
                        jout["gaussians"].opacities),
                       ("harmonics", tout["gaussians"].harmonics,
                        jout["gaussians"].harmonics),
                       ("poses", tout["gaussian_camera_extrins"],
                        jout["gaussian_camera_extrins"])):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err < 2e-4, (name, err)


def test_load_weights_refuses_other_formats_and_configs(tmp_path):
    _, tcfg = _pose_cfgs()
    model = init_vicasplat(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        checkpointing.load_weights(tmp_path, model)  # an orbax directory
    with pytest.raises(FileNotFoundError):  # a PyTorch checkpoint, read by the converter
        checkpointing.load_weights(tmp_path / "re10k_8view.ckpt", model)
    other = init_vicasplat(dataclasses.replace(tcfg, backbone=dataclasses.replace(
        tcfg.backbone, use_framewise_modulation=False)), torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="leaves"):
        checkpointing.load_weights(NPZ, other)
    small = init_vicasplat(dataclasses.replace(tcfg, gaussian_adapter=dataclasses.replace(
        tcfg.gaussian_adapter, sh_degree=0)), torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="shape"):
        checkpointing.load_weights(NPZ, small)
