"""Guards of the port's boundaries: what it may import, and that
chip_smoke.py refuses to run without a CUDA card."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "vicasplat_tpu_torch"
ALLOWED = {"torch", "numpy", "vicasplat_tpu_torch"}
# may be imported inside a function, never at the top: Triton where a kernel
# launches, OpenCV where save_video is asked for an mp4, wandb where a logger
# is asked for it
LAZY_ONLY = {"triton", "cv2", "wandb"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(tree):
    """(top-level module, at module level?) for every import in the file."""
    top_level = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            yield name.split(".")[0], id(node) in top_level


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for kernel in ("flash_attn", "composite", "dpt_tail", "bitonic_topk"):
        assert f"vicasplat_tpu_torch/kernels/{kernel}.py" in names
        assert (PORT / "csrc" / f"{kernel}.cu").exists()
    assert "vicasplat_tpu_torch/ops/rasterize/pallas_composite.py" in names
    # the synthetic scene generator, copied from the JAX package's data/
    assert "vicasplat_tpu_torch/data/synthetic_scenes.py" in names
    # K1's backward, its float32 route and the Hopper header they share
    for src in ("flash_attn_bwd.cu", "flash_attn_f32.cu", "hopper.cuh"):
        assert (PORT / "csrc" / src).exists(), src
    # the evaluation path: the two entry points and the modules they run
    for mod in ("main", "eval_pose", "evaluation/nvs_eval", "evaluation/pose_evaluator",
                "evaluation/metrics", "loss/ssim", "data/data_module",
                "data/view_samplers", "utils/config", "utils/yaml_subset",
                "utils/checkpointing", "utils/benchmarker", "utils/image_io",
                # the train mode's
                "utils/step_tracker", "utils/loggers", "loss/lpips",
                "visualization/layout", "visualization/colormaps",
                "visualization/bitmap_font",
                # the serving path's
                "serving", "streaming", "ops/quant", "utils/device_cache",
                # the demo flow's, the visual outputs' and the export's
                "demo", "export", "utils/ply", "visualization/camera_trajectory",
                "visualization/video_render", "visualization/glb",
                "visualization/drawing", "visualization/validation_in_3d",
                "visualization/viewer", "visualization/viewer_server",
                # the RE10K data path's
                "geometry_np", "geometry/epipolar", "data/shims", "data/dataset_re10k",
                "data/dataset_scannet", "data/colmap", "data/convert_scripts",
                "evaluation/index_generator", "evaluation/extend_index",
                "evaluation/metric_computer", "utils/host_image"):
        assert f"vicasplat_tpu_torch/{mod}.py" in names, mod
    # the host C++ of the JPEG codec and the resize
    assert (PORT / "csrc" / "image_host.cpp").exists()
    # the last modules of the JAX tree: MoE, parallelism, the render oracle
    for mod in ("models/moe", "ops/rasterize/reference", "parallel/__init__",
                "parallel/mesh", "parallel/view_parallel", "parallel/ep",
                "parallel/tp", "parallel/sp", "parallel/pp",
                "parallel/memory_proof",
                # the run across several cards (__graft_entry__.dryrun_multichip)
                "multichip"):
        assert f"vicasplat_tpu_torch/{mod}.py" in names, mod
    # the per-device shared-memory opt-in every CUDA source includes
    assert (PORT / "csrc" / "smem_limit.cuh").exists()


# JAX modules whose counterparts sit elsewhere in the port
MOVED = {"ops/dpt_tail.py": "kernels/dpt_tail.py",
         "ops/rasterize/pallas_bitonic.py": "kernels/bitonic_topk.py",
         "data/native/__init__.py": "csrc/image_host.cpp",
         "data/native/jpeg_native.cpp": "csrc/image_host.cpp"}


def test_every_jax_module_has_a_counterpart():
    """File by file, every Python and C++ source of the JAX package has one
    in the port, at the same path or where MOVED says."""
    jax_root = ROOT / "vicasplat_tpu"
    missing = []
    for p in sorted(jax_root.rglob("*")):
        if p.suffix not in (".py", ".cpp") or "__pycache__" in p.parts:
            continue
        rel = p.relative_to(jax_root).as_posix()
        if not (PORT / MOVED.get(rel, rel)).exists():
            missing.append(rel)
    assert not missing, missing


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_only_torch_numpy_and_stdlib(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for mod, at_top in _imports(tree):
        if mod in ALLOWED or mod in sys.stdlib_module_names:
            continue
        if mod in LAZY_ONLY and not at_top:
            continue
        bad.append(mod)
    assert not bad, f"{path} imports {bad}"


def test_import_guard_catches_jax():
    """The scan itself sees a JAX import, top-level or nested."""
    src = "import numpy\ndef f():\n    from jax import numpy as jnp\n"
    mods = [m for m, _ in _imports(ast.parse(src))]
    assert "jax" in mods and "numpy" in mods
    top = dict(_imports(ast.parse("import triton\n")))
    assert top["triton"] is True


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Here there is no CUDA card: the script exits non-zero and prints no
    result, so nothing falls back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and obj.get("ok") is True), line
    assert '"ok": true' not in proc.stdout


# public top-level names of the JAX package that the port keeps in another
# form, by (module, name): where the counterpart is, or why there is none
ELSEWHERE = {
    ("data/dataset_re10k.py", "decode_jpegs"):
        "utils/host_image.decode_jpegs_u8 (the port's own codec), then a cast",
    ("data/native/__init__.py", "load"):
        "kernels/build.load_host builds and loads csrc/image_host.cpp",
    ("data/native/__init__.py", "decode_jpegs_u8_native"):
        "utils/host_image.decode_jpegs_u8 over csrc/image_host.cpp",
    ("decoder/__init__.py", "get_decoder"):
        "a registry of one decoder: decoder/splatting.decoder_forward is called directly",
    ("models/__init__.py", "get_encoder"):
        "a registry of one encoder: models/vicasplat.VicaSplat is built directly",
    ("loss/lpips.py", "main"):
        "the CLI that converts torchvision's VGG weights into the npz both sides read",
    ("models/heads.py", "init_dpt"): "the nn.Module constructor heads.DPT",
    ("models/heads.py", "dpt_trunk"): "heads.DPT.trunk",
    ("models/heads.py", "init_linear_head"): "the nn.Module constructor heads.LinearHead",
    ("models/heads.py", "init_camera_extrinsic_head"):
        "the nn.Module constructor heads.CameraHead",
    ("models/heads.py", "init_camera_intrinsic_head"):
        "the nn.Module constructor heads.CameraHead",
    ("models/layers.py", "xavier_uniform"): "layers' nn.Module constructors (torch init)",
    ("models/layers.py", "normal_init"): "layers.fill_normal_",
    ("models/layers.py", "linear_init"): "the nn.Module constructor nn.Linear",
    ("models/layers.py", "layernorm_init"): "the nn.Module constructor nn.LayerNorm",
    ("models/layers.py", "mlp_init"): "the nn.Module constructor layers.Mlp",
    ("models/layers.py", "conv_init"): "the nn.Module constructor nn.Conv2d",
    ("models/layers.py", "conv2d_im2col"):
        "an XLA formulation of one convolution: F.conv2d (cuDNN)",
    ("models/layers.py", "conv2d_s2d"):
        "an XLA formulation of one convolution: F.conv2d (cuDNN)",
    ("models/layers.py", "conv2d_s2d_folded"):
        "an XLA formulation of one convolution: F.conv2d (cuDNN)",
    ("models/layers.py", "sdpa_xla"): "layers.sdpa",
    ("models/moe.py", "moe_init"): "the nn.Module constructor moe.MoeMlp",
    ("models/vicanet.py", "init_vicanet"): "the nn.Module constructor vicanet.VicaNet",
    ("models/vicanet.py", "vicanet_forward"): "vicanet.VicaNet.forward",
    ("ops/rasterize/pallas_bitonic.py", "bitonic_topk_u32"):
        "kernels/bitonic_topk.bitonic_topk (K4)",
    ("ops/rasterize/pallas_composite.py", "composite_tiles_pallas"):
        "pallas_composite.composite_tiles_kernel (K2)",
    ("ops/rasterize/tiles.py", "TileBins"):
        "a NamedTuple of the binning's arrays: bin_splats returns the tensors",
    ("parallel/mesh.py", "initialize_multihost"): "mesh.init_distributed",
    ("parallel/tp.py", "tp_spec"): "a JAX PartitionSpec: tp.TP_RULES and tp.tp_rule",
    ("training/optimizer.py", "lr_multiplier_tree"): "optimizer.lr_multipliers",
    ("training/optimizer.py", "make_optimizer"): "the constructor optimizer.AdamW",
}


def _public_defs(tree):
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _bound_names(tree):
    """Every name bound at the top of a module: definitions, assignments,
    imports."""
    out = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                out.update(x.id for x in ast.walk(t) if isinstance(x, ast.Name))
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in n.names)
    return out


_JAX_MODULES = sorted(p.relative_to(ROOT / "vicasplat_tpu").as_posix()
                      for p in (ROOT / "vicasplat_tpu").rglob("*.py")
                      if "__pycache__" not in p.parts)


@pytest.mark.parametrize("rel", _JAX_MODULES)
def test_every_jax_public_name_has_a_counterpart(rel):
    """Name by name: every public function and class at the top of a JAX
    module is bound at the top of its port counterpart (MOVED's, or the
    same path), or ELSEWHERE names its counterpart or reason; and each of
    ELSEWHERE's entries is still needed."""
    jax_tree = ast.parse((ROOT / "vicasplat_tpu" / rel).read_text())
    port = PORT / MOVED.get(rel, rel)
    bound = _bound_names(ast.parse(port.read_text())) if port.suffix == ".py" else set()
    names = _public_defs(jax_tree)
    missing = [n for n in names if n not in bound and (rel, n) not in ELSEWHERE]
    assert not missing, f"{rel}: no counterpart in {port.name} for {missing}"
    stale = [n for (m, n) in ELSEWHERE if m == rel and (n not in names or n in bound)]
    assert not stale, f"{rel}: ELSEWHERE lists {stale}, which need no entry"


def test_elsewhere_names_jax_modules():
    assert {m for m, _ in ELSEWHERE} <= set(_JAX_MODULES)
