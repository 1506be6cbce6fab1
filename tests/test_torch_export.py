"""The port's AOT export (vicasplat_tpu_torch/export.py) against the JAX
package's (vicasplat_tpu/export.py), in float32 on the CPU at a toy size:
artifacts exported on the CPU (the reconstruct in float32, and through the
CLI with --quantize from an npz of the same weights; the render with and
without the kernels' operators), loaded and called in one child process
that imports torch and the port's kernels and never its models, held
against JAX's deserialized artifacts on the same weights and against the
port's eager engine; and that an artifact holds no weight."""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jexport

from tests.test_torch_model import TOL
from tests.test_torch_render import jax_exact_depth_order
from vicasplat_tpu import export as jex
from vicasplat_tpu import serving as jserving
from vicasplat_tpu.decoder.splatting import DecoderSplattingConfig as JDecCfg
from vicasplat_tpu.models import adapter as jad
from vicasplat_tpu.models import vicasplat as jvs
from vicasplat_tpu.models.vicanet import VicaNetConfig as JNetCfg
from vicasplat_tpu_torch import export as tex
from vicasplat_tpu_torch import models as tmodels
from vicasplat_tpu_torch import serving as tserving
from vicasplat_tpu_torch.decoder import splatting as tsp
from vicasplat_tpu_torch.decoder.splatting import DecoderSplattingConfig as TDecCfg
from vicasplat_tpu_torch.models import adapter as tad
from vicasplat_tpu_torch.models import vicasplat as tvs
from vicasplat_tpu_torch.models.vicanet import VicaNetConfig as TNetCfg
from vicasplat_tpu_torch.ops.rasterize import RasterizeConfig as TRasterCfg
from vicasplat_tpu_torch.utils import checkpointing

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the forward in float32 on both sides (see tests/test_torch_model.py):
# means within 1e-4 and poses within 1e-5 of JAX's
MEANS_TOL = 1e-4
POSE_TOL = 1e-5
# the same splats composited by two matmul orders, far below 1/255
IMG_TOL = 1e-4
# the toy backbone (fewer blocks than tests/test_torch_model.py's: the
# export's time grows with the graph) at the CLI's SH degree 4
NET = dict(patch_size=16, enc_embed_dim=64, enc_depth=1, enc_num_heads=4,
           dec_embed_dim=48, dec_depth=2, dec_num_heads=4,
           use_intrinsic_embedding=True, temporal_rope_theta=30.0)
SIZE, T, V = 32, 2, 1
# the render's background: a colour no other call builds, so that its
# constant is first made under the render's trace (the constant-cache test)
BG = (0.125, 0.25, 0.375)
# the accelerator configuration's small rasterizer (tests/test_torch_render.py)
SMALL = dict(tile_px=8, dup_hw=(4, 4), max_per_tile=64, chunk=32, tile_group=16,
             pallas_chunk=32)

# imports torch and the port's kernels only: loads each artifact once, runs
# its calls, and reports its operators and signature
CHILD = textwrap.dedent("""
    import sys
    import torch
    import vicasplat_tpu_torch.kernels  # registers torch.ops.vicasplat.*
    torch.set_num_threads(1)
    jobs = torch.load(sys.argv[1], weights_only=True)
    programs, outs, info = {}, {}, {}
    for name, (path, args) in jobs.items():
        if path not in programs:
            ep = programs[path] = torch.export.load(path)
            info[path] = {
                "ops": sorted({str(n.target) for n in ep.graph.nodes
                               if str(n.target).startswith("vicasplat.")}),
                "kinds": [s.kind.name for s in ep.graph_signature.input_specs],
                "state": len(ep.state_dict),
                "const_bytes": sum(t.numel() * t.element_size()
                                   for t in ep.constants.values())}
        outs[name] = programs[path].module()(*args)
    bad = sorted(m for m in sys.modules
                 if m.startswith(("vicasplat_tpu_torch.models", "vicasplat_tpu.", "jax")))
    assert not bad, bad
    assert "vicasplat_tpu" not in sys.modules
    torch.save({"outs": outs, "info": info}, sys.argv[2])
""")


def start_child(tmp_path, jobs: dict) -> subprocess.Popen:
    """Start the child on {name: (artifact path, args)}; `child_results`
    collects {"outs": {name: outputs}, "info": {path: ...}}."""
    torch.save({k: (str(p), a) for k, (p, a) in jobs.items()}, tmp_path / "jobs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.Popen([sys.executable, "-c", CHILD, str(tmp_path / "jobs.pt"),
                             str(tmp_path / "outs.pt")], cwd=tmp_path, env=env)


def child_results(proc: subprocess.Popen, tmp_path) -> dict:
    assert proc.wait(timeout=300) == 0
    return torch.load(tmp_path / "outs.pt", weights_only=True)


def cfgs():
    jcfg = jvs.VicaSplatConfig(backbone=JNetCfg(img_size=SIZE, **NET),
                               gaussian_adapter=jad.GaussianAdapterConfig(sh_degree=4))
    tcfg = tvs.VicaSplatConfig(backbone=TNetCfg(img_size=SIZE, **NET),
                               gaussian_adapter=tad.GaussianAdapterConfig(sh_degree=4))
    return jcfg, tcfg


def random_params(jcfg, seed):
    """A JAX param tree of the config's shapes (by `jax.eval_shape`, which
    skips the init's many small compiles) filled from a numpy seed:
    LayerNorm scales 1 + N(0, 0.02), matrices and kernels N(0, 0.5 /
    sqrt(fan_in)), every other leaf N(0, 0.02); no leaf is zero, and the
    scales keep the exp map of the means near 1, as the JAX init does."""
    shapes = jax.eval_shape(lambda: jvs.init_vicasplat(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        shape, name = leaf.shape, str(path[-1])
        if "scale" in name:
            x = 1.0 + rng.normal(0, 0.02, shape)
        elif len(shape) >= 2:
            x = rng.normal(0, 0.5 / np.sqrt(np.prod(shape[:-1])), shape)
        else:
            x = rng.normal(0, 0.02, shape)
        return jnp.asarray(x, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (1, T, SIZE, SIZE, 3)).astype(np.float32)
    K = np.ascontiguousarray(np.broadcast_to(
        np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], np.float32),
        (1, T, 3, 3)))
    return images, K


def render_inputs():
    ext = np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1))
    ext[:, :, 2, 3] = np.linspace(-6.0, -4.0, V)
    K = np.broadcast_to(
        np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], np.float32),
        (1, V, 3, 3)).copy()
    return ext, K, np.full((1, V), 0.05, np.float32), np.full((1, V), 100.0, np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Both packages' artifacts of the same weights, and the child's results."""
    tmp = tmp_path_factory.mktemp("export")
    jcfg, tcfg = cfgs()
    params = random_params(jcfg, 1)
    other = random_params(jcfg, 7)
    images, K = inputs()
    rargs = render_inputs()
    f32 = tserving.InferenceEngine(tcfg, params=params, dtype=torch.float32, device="cpu",
                                   decoder=TDecCfg(background_color=BG))
    other_eng = tserving.InferenceEngine(tcfg, params=other, dtype=torch.float32,
                                         device="cpu")
    accel = tserving.InferenceEngine(
        tcfg, model=f32.model, dtype=torch.float32, device="cpu",
        decoder=TDecCfg(rasterize=TRasterCfg(backend="pallas", binning="origin", **SMALL)))
    paths = {k: tmp / f"{k}.pt2" for k in ("f32", "int8", "render", "render_accel")}
    tex.save_exported(paths["f32"], tex.export_reconstruct(f32, 1, T, SIZE, SIZE,
                                                           with_intrinsics=True))
    # the CLI, from an npz of the same weights, with --quantize
    npz = tmp / "weights.npz"
    checkpointing.write_npz(npz, checkpointing.snapshot(f32.model, 0))
    with mock.patch.object(tmodels, "VicaNetConfig",
                           lambda img_size: TNetCfg(img_size=img_size, **NET)):
        tex.main(["--out", str(paths["int8"]), "--ckpt", str(npz), "--frames", str(T),
                  "--size", str(SIZE), "--quantize", "--device", "cpu"])
    # the CLI's engine: the flagship's bf16 weights from the npz, quantized
    int8 = tserving.InferenceEngine(dataclasses.replace(tcfg), ckpt=str(npz),
                                    quantize=True, device="cpu")
    tex.save_exported(paths["render"], tex.export_render(f32, (1, T, SIZE, SIZE), V,
                                                         (SIZE, SIZE)))
    tex.save_exported(paths["render_accel"], tex.export_render(
        accel, (1, T, SIZE, SIZE), V, (SIZE, SIZE)))
    scene = f32.reconstruct(images, K)
    g_dict = dict(scene.gaussians._asdict())
    t_in = (torch.from_numpy(images), torch.from_numpy(K))
    t_r = (g_dict, *(torch.from_numpy(x) for x in rargs))
    proc = start_child(tmp, {
        "f32": (paths["f32"], (tex.weights(f32), *t_in)),
        "f32_other": (paths["f32"], (tex.weights(other_eng), *t_in)),
        "int8": (paths["int8"], (tex.weights(int8), *t_in)),
        "render": (paths["render"], t_r),
        "render_accel": (paths["render_accel"], t_r)})
    # JAX: the same weights through its own artifacts, while the child runs
    jref = {}
    for name, kw in (("f32", dict(dtype=jnp.float32)),
                     ("int8", dict(quantize=True))):  # the JAX CLI's bf16 engine
        je = jserving.InferenceEngine(jcfg, params=params, **kw)
        exp = jexport.deserialize(jex.export_reconstruct(je, 1, T, SIZE, SIZE,
                                                         with_intrinsics=True))
        jref[name] = exp.call(je.params, jnp.asarray(images), jnp.asarray(K))
    je = jserving.InferenceEngine(jcfg, params=params, dtype=jnp.float32,
                                  decoder=JDecCfg(background_color=BG))
    with jax_exact_depth_order():  # JAX's dup-sort keys tie close depths
        exp = jexport.deserialize(jex.export_render(je, (1, T, SIZE, SIZE), V,
                                                    (SIZE, SIZE)))
    jref["render"] = exp.call({k: jnp.asarray(v.numpy()) for k, v in g_dict.items()},
                              *(jnp.asarray(x) for x in rargs))
    child = child_results(proc, tmp)
    return dict(engines={"f32": f32, "int8": int8, "accel": accel, "other": other_eng},
                child=child, jref=jref, images=images, K=K, paths=paths,
                render_args=t_r, tcfg=tcfg)


def test_loaded_f32_reconstruct_matches_jax_artifact(setup):
    out, ref = setup["child"]["outs"]["f32"], setup["jref"]["f32"]
    np.testing.assert_allclose(out["poses"].numpy(), np.asarray(ref["poses"]),
                               atol=POSE_TOL, rtol=0)
    assert sorted(out["gaussians"]) == sorted(ref["gaussians"])
    np.testing.assert_allclose(out["gaussians"]["means"].numpy(),
                               np.asarray(ref["gaussians"]["means"]), atol=MEANS_TOL,
                               rtol=0)
    for k in ("opacities", "scales", "rotations", "harmonics", "covariances"):
        np.testing.assert_allclose(out["gaussians"][k].numpy(),
                                   np.asarray(ref["gaussians"][k]), atol=TOL, rtol=TOL,
                                   err_msg=k)
    assert "intrinsics" not in out and "intrinsics" not in ref


def test_loaded_quantized_reconstruct_matches_jax_artifact(setup):
    """Both CLIs' engines: bf16 weights, every large linear W8A8. bf16 on
    both sides, summed in other orders: held as the JAX engine's own bf16
    answers are to its float32 ones (PERF.md §4), 2e-2."""
    out, ref = setup["child"]["outs"]["int8"], setup["jref"]["int8"]
    assert setup["engines"]["int8"].n_quantized > 0
    np.testing.assert_allclose(out["poses"].float().numpy(),
                               np.asarray(ref["poses"], np.float32), atol=2e-2, rtol=0)
    m, r = out["gaussians"]["means"].float().numpy(), np.asarray(
        ref["gaussians"]["means"], np.float32)
    assert np.corrcoef(m.ravel(), r.ravel())[0, 1] > 0.99


@pytest.mark.parametrize("name", ["f32", "int8"])
def test_loaded_reconstruct_equals_the_eager_engine(setup, name):
    """The exported graph runs the eager program's operators: bit for bit."""
    sb = setup["engines"][name].reconstruct(setup["images"], setup["K"])
    out = setup["child"]["outs"][name]
    assert torch.equal(out["poses"], sb.poses)
    for k, v in sb.gaussians._asdict().items():
        assert torch.equal(out["gaussians"][k], v), k


def test_loaded_renders_match(setup):
    """The default render against JAX's artifact (its tiles' lists in exact
    depth order, `jax_exact_depth_order`); the accelerator render
    (K2 and K4 by their operators, plain versions on the CPU) against the
    eager engine bit for bit."""
    out, ref = setup["child"]["outs"]["render"], setup["jref"]["render"]
    assert float(out["alpha"].max()) > 0.1  # the splats land in the views
    for k in ("color", "depth", "alpha"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=IMG_TOL,
                                   rtol=0, err_msg=k)
    g_dict, ext, tK, _, _ = setup["render_args"]
    scene = tserving.SceneBatch(gaussians=tmodels.Gaussians(**g_dict), poses=None,
                                intrinsics=None)
    eager = setup["engines"]["accel"].render(scene, ext, tK, (SIZE, SIZE))
    acc = setup["child"]["outs"]["render_accel"]
    assert float(acc["alpha"].max()) > 0.1
    for k in ("color", "depth", "alpha"):
        assert torch.equal(acc[k], getattr(eager, k)), k


def test_graphs_call_the_kernels_operators(setup):
    info, p = setup["child"]["info"], setup["paths"]
    assert info[str(p["f32"])]["ops"] == ["vicasplat.flash_attn.default"]
    assert info[str(p["int8"])]["ops"] == ["vicasplat.flash_attn.default"]
    assert info[str(p["render"])]["ops"] == []
    assert info[str(p["render_accel"])]["ops"] == ["vicasplat.bitonic_topk.default",
                                                   "vicasplat.composite.default"]


@pytest.mark.parametrize("name", ["f32", "int8"])
def test_artifact_holds_no_weight(setup, name):
    """No parameter or buffer is stored: the weights are user inputs, and
    the constants (tables) are under 1 % of the weights' bytes."""
    info = setup["child"]["info"][str(setup["paths"][name])]
    assert info["state"] == 0
    assert set(info["kinds"]) <= {"USER_INPUT", "CONSTANT_TENSOR"}
    w = tex.weights(setup["engines"][name])
    assert info["kinds"].count("USER_INPUT") == len(w) + 2
    assert info["const_bytes"] < 0.01 * sum(t.numel() * t.element_size()
                                            for t in w.values())
    assert setup["paths"][name].stat().st_size > 0


def test_one_artifact_serves_other_weights(setup):
    sb = setup["engines"]["other"].reconstruct(setup["images"], setup["K"])
    outs = setup["child"]["outs"]
    assert torch.equal(outs["f32_other"]["gaussians"]["means"], sb.gaussians.means)
    assert not torch.equal(outs["f32_other"]["gaussians"]["means"],
                           outs["f32"]["gaussians"]["means"])


def test_trace_leaves_no_fake_tensor_in_the_constant_cache(setup):
    """The render's background colour was first built under its trace (in
    the fixture): the trace must not have cached its fake tensor."""
    t = tsp._background(BG, torch.device("cpu"))
    assert type(t) is torch.Tensor and t.tolist() == list(BG)


def test_weights_are_the_state_dict(setup):
    eng = setup["engines"]["f32"]
    w = tex.weights(eng)
    assert list(w) == list(eng.model.state_dict())
    assert not any(t.requires_grad for t in w.values())
