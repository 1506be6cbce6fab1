"""The port's parallel routes (vicasplat_tpu_torch/parallel, DDP in
training/step.py, MoE expert parallelism) on gloo process groups on the
CPU, against the JAX package's unsharded calls and the port's own serial
ones, in float32.

One group of 2 and one of 4 processes (torch.multiprocessing, spawned once
for the whole file, over FileStores under tmp_path: no TCP port, so xdist
workers cannot collide) run tests/torch_parallel_worker.py: every rank runs
every route of its world size and saves its results; the tests here compare
them. World 2: shard_batch and replicate, DDP against the single-process
step (with and without accumulation), FSDP2's sharding rule and step, the
view-sharded render, the GPipe pipeline, EP on a (1, 2) mesh. World 4:
tensor and sequence parallelism on (2, 2) meshes and EP on a (2, 2)
data x expert mesh."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tests import torch_parallel_worker as worker
from vicasplat_tpu.decoder.splatting import DecoderSplattingConfig as JDecCfg
from vicasplat_tpu.decoder.splatting import decoder_forward as jdecoder_forward
from vicasplat_tpu.models import moe as jmoe
from vicasplat_tpu.models import vicanet as jvn
from vicasplat_tpu.models.adapter import Gaussians as JGaussians
from vicasplat_tpu.models.adapter import build_covariance
from vicasplat_tpu.ops.rasterize import RasterizeConfig as JRasterCfg
from vicasplat_tpu_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(1)

# the tiny VicaNet in float32 against JAX (tests/test_torch_vicanet.py's
# rule); a sharded route sums the same products over other splits
NET_TOL = 1e-4
# the routed MLP against JAX (tests/test_torch_moe.py)
MOE_TOL = 1e-5
# renders against JAX's serial decoder_forward (tests/test_torch_render.py);
# with make_scale_invariant the rescale moves from the packed covariances to
# the Gaussians before the split (float32 rounding of the scaled inputs)
IMG_TOL = 1e-4
# the same float32 step, gradients averaged over 2 ranks (or micro-batches
# summed) instead of one pass over the batch: sums in other orders, ~1e-6
# relative; held at 1e-5 of each tensor's largest gradient
GRAD_TOL = 1e-5
LOSS_TOL = 1e-6
# GPipe sums each gradient over its micro-batches, one example each, where
# the serial pass sums over the batch: the two orders leave a few entries
# of a tensor ~1e-5 of its largest apart
PP_GRAD_TOL = 1e-4
# a whole step in micro-batches of one example against one pass over the
# batch: batch-size dependent float32 sums, and the rasterizer's 1/255
# alpha cut acting on them, move gradients by up to 1e-3 of a tensor's
# largest, as tests/test_torch_training.py holds the port against JAX
WHOLE_GRAD_TOL = 1e-3
# one AdamW step from those gradients: the first update is lr * mult *
# (g / |g| + wd * p), so an entry moves by at most about 2 lr * mult when
# its gradient is at rounding level and its sign differs; lr = 1e-3
PARAM_TOL = 2e-3
# an entry whose gradient is above 1e-4 of its tensor's largest has a
# well-determined sign: there the parameters agree to rounding
PARAM_FINE = 1e-6
TINY = dict(img_size=32, patch_size=16, enc_embed_dim=64, enc_depth=2,
            enc_num_heads=4, dec_embed_dim=48, dec_depth=4, dec_num_heads=4,
            use_flash_attention=False)


def _numpy_tree(shapes, rng, std):
    """A param tree of `jax.eval_shape`'s shapes drawn by numpy (JAX's
    threefry init is the slow part at any size)."""
    return jax.tree.map(lambda x: rng.normal(0, std, x.shape).astype(np.float32),
                        shapes)


def _inputs():
    """Every input of the ranks (numpy and torch), and a function that
    computes the JAX references, run while the ranks work."""
    rng = np.random.default_rng(0)
    jcfg = jvn.VicaNetConfig(**TINY)
    params = _numpy_tree(jax.eval_shape(lambda k: jvn.init_vicanet(k, jcfg),
                                        jax.random.PRNGKey(0)), rng, 0.2)
    images = rng.uniform(-1, 1, (2, 2, 32, 32, 3)).astype(np.float32)
    K = (np.eye(3, dtype=np.float32) + rng.normal(0, 0.05, (2, 2, 3, 3))
         ).astype(np.float32)
    K[..., 2, :] = [0, 0, 1]
    K[..., 0, 2] += 0.5
    K[..., 1, 2] += 0.5

    moe_dims = (16, 32, 4)
    moe_p = _numpy_tree(jax.eval_shape(lambda k: jmoe.moe_init(k, *moe_dims),
                                       jax.random.PRNGKey(2)), rng, 0.5)
    moe_x = rng.normal(size=(24, 16)).astype(np.float32)

    n = 300
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(2.0, 6.0, n)], -1).astype(np.float32)
    scales = rng.uniform(0.03, 0.2, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    covs = np.array(build_covariance(jnp.asarray(scales), jnp.asarray(quats)))
    g = dict(means=means[None], covariances=covs[None],
             harmonics=rng.normal(0, 0.3, (1, n, 3, 4)).astype(np.float32),
             opacities=rng.uniform(0.2, 1.0, (1, n)).astype(np.float32))
    V = 3  # over 2 ranks: a ragged tail
    ext = np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1))
    ext[0, :, :3, 3] = rng.normal(0, 0.2, (V, 3))
    cams = (ext, np.tile(np.array([[0.9, 0, 0.5], [0, 1.1, 0.48], [0, 0, 1]],
                                  np.float32), (1, V, 1, 1)),
            np.array([[0.8, 0.5, 0.7]], np.float32), np.full((1, V), 100.0, np.float32))
    raster = dict(tile_px=8, dup_hw=(4, 4), max_per_tile=64, chunk=32,
                  tile_group=16)

    def references():
        net = jvn.vicanet_forward(params, jcfg, jnp.asarray(images), jnp.asarray(K),
                                  dtype=jnp.float32)
        moe = jmoe.moe_mlp(moe_p, jnp.asarray(moe_x), top_k=2,
                           capacity_factor=0.5, return_aux=True)
        view = {}
        for inv in (False, True):
            cfg = JDecCfg(make_scale_invariant=inv, rasterize=JRasterCfg(**raster))
            jg = JGaussians(**{k: jnp.asarray(v) for k, v in g.items()},
                            scales=None, rotations=None)
            view[inv] = [np.asarray(x) for x in jdecoder_forward(
                cfg, jg, *map(jnp.asarray, cams), (32, 32))]
        return {"net": net, "moe": moe, "view": view}

    scan_blocks = torch.nn.ModuleList(torch.nn.Linear(6, 6) for _ in range(4))
    torch.manual_seed(0)
    for p in scan_blocks.parameters():
        torch.nn.init.normal_(p, 0, 0.4)
    t = torch.from_numpy
    inp = {
        "net_cfg": dataclasses.asdict(jcfg), "net_sd": state_dict_from_jax(params),
        "images": t(images), "K": t(K),
        "moe_dims": moe_dims, "moe_sd": state_dict_from_jax(moe_p), "moe_x": t(moe_x),
        "gaussians": {k: t(v) for k, v in g.items()} | {"scales": None,
                                                         "rotations": None},
        "cams": tuple(t(c) for c in cams), "raster": raster,
        "scan_blocks": scan_blocks.state_dict(),
        "scan_x": t(rng.normal(size=(4, 6)).astype(np.float32)),
    }
    return inp, references


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel"))
    inp, references = _inputs()
    torch.save(inp, os.path.join(root, "inputs.pt"))
    inp["root"] = root
    ctxs = [mp.start_processes(worker.main, args=(w, root), nprocs=w, join=False,
                               start_method="spawn") for w in (2, 4)]
    refs = references()  # JAX, while the ranks run
    for c in ctxs:
        while not c.join(timeout=300):
            pass
    res = {w: [torch.load(os.path.join(root, f"w{w}_r{r}.pt"), weights_only=False)
               for r in range(w)] for w in (2, 4)}
    for w, ranks in res.items():
        for r, out in enumerate(ranks):
            assert not out["errors"], f"world {w} rank {r}:\n" + "\n".join(out["errors"])
    return res, inp, refs


def test_shard_batch_and_replicate(runs):
    res, _, _ = runs
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    for r, out in enumerate(res[2]):
        np.testing.assert_array_equal(out["shard_batch"], x[3 * r:3 * r + 3])
        np.testing.assert_array_equal(out["replicated"], np.ones((2, 3)))


def _same_step(d, grad_tol=GRAD_TOL, norm_tol=GRAD_TOL, params=True):
    np.testing.assert_allclose(*d["loss"], rtol=LOSS_TOL)
    np.testing.assert_allclose(*d["grad_norm"], rtol=norm_tol)
    assert d["same_keys"]
    for k, (dg, scale, dp, dp_sure) in d["rows"].items():
        assert dg <= grad_tol * scale + 1e-12, (k, dg, scale)
        if params:
            assert dp <= PARAM_TOL and dp_sure <= PARAM_FINE, (k, dp, dp_sure)


@pytest.mark.parametrize("route", ["ddp", "ddp_accum", "fsdp"])
def test_data_parallel_step_equals_single_process(runs, route):
    """DP's gradient is the full batch's (JAX's test_dp_psum_semantics), and
    one DDP or FSDP2 step equals the single-process step on the whole batch:
    loss, gradient norm, gradients and parameters after AdamW. The
    reference runs the whole batch in micro-batches of one example, as each
    rank does, so that only the ranks' averaging differs."""
    res, _, _ = runs
    _same_step(res[2][1 if route == "ddp_accum" else 0][route])
    # DDP keeps the replicas equal
    assert res[2][0]["ddp_checksum"] == res[2][1]["ddp_checksum"]


def test_ddp_step_near_one_pass_over_the_batch(runs):
    """The same step against one pass over both examples (WHOLE_GRAD_TOL)."""
    res, _, _ = runs
    _same_step(res[2][0]["ddp_whole"], grad_tol=WHOLE_GRAD_TOL,
               norm_tol=WHOLE_GRAD_TOL, params=False)


def test_train_mode_under_ddp(runs, tmp_path):
    """main.py's train mode at world 2 (as torchrun runs it) against the
    same command in one process: each step's loss and gradient norm, the
    replicas equal, rank 0 alone logging and writing the checkpoint."""
    from tests.torch_parallel_worker import TRAIN_MODE
    from vicasplat_tpu_torch import main as tmain

    res, inp, _ = runs
    ranks = [out["train_mode"] for out in res[2]]
    one = tmain.main([*TRAIN_MODE, f"output_dir={tmp_path}",
                      f"checkpointing.output_dir={tmp_path}/ckpts"], device="cpu")
    assert ranks[0]["step"] == ranks[1]["step"] == one["step"] == 2
    assert ranks[0]["checksum"] == ranks[1]["checksum"]
    assert not ranks[1]["logs"] and len(ranks[0]["logs"]) == len(one["logs"]) == 2
    for got, want in zip(ranks[0]["logs"], one["logs"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_TOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=WHOLE_GRAD_TOL)
    ckpts = os.path.join(inp["root"], "train_mode", "ckpts")
    assert sorted(os.listdir(ckpts)) == ["step_00000002.npz"]


def test_fsdp_sharding_rule(runs):
    """JAX's test_fsdp_sharding: a big leaf shards along its largest dim the
    world divides; small and indivisible leaves stay whole."""
    res, _, _ = runs
    out = res[2][0]
    placed, rule = out["fsdp_placed"], out["fsdp_rule"]
    assert set(placed) == set(rule)
    n_sharded = 0
    for name, dim in rule.items():
        assert placed[name][0] == dim, name
        n_sharded += dim is not None
    assert 0 < n_sharded < len(rule)
    w = "backbone.enc_blocks.0.mlp.fc1.weight"  # (256, 64): rows halve
    assert rule[w] == 0 and placed[w][1] == (128, 64)


@pytest.mark.parametrize("invariant", [False, True])
def test_view_sharded_render_matches_jax(runs, invariant):
    res, _, refs = runs
    for out in res[2]:
        got = out[f"view_{invariant}"]
        assert got[0].shape == (1, 3, 32, 32, 3)
        for a, b in zip(got, refs["view"][invariant]):
            np.testing.assert_allclose(a, b, atol=IMG_TOL)
    assert float(refs["view"][invariant][2].max()) > 0.5


def _net_close(got, ref, rows=slice(None)):
    _, cam, _, inter = ref
    assert len(got["inter"]) == len(inter)
    for i, (a, b) in enumerate(zip(got["inter"], inter)):
        np.testing.assert_allclose(a, np.asarray(b)[rows], atol=NET_TOL,
                                   rtol=NET_TOL, err_msg=f"intermediate {i}")
    np.testing.assert_allclose(got["cam"], np.asarray(cam)[rows], atol=NET_TOL,
                               rtol=NET_TOL)


def test_pipeline_forward_and_grads(runs):
    """GPipe over 2 stages (2 micro-batches) against JAX's unsharded forward;
    each stage's gradients against the serial port's."""
    res, _, refs = runs
    metas = []
    for out in res[2]:
        _net_close(out["pp"], refs["net"])
        np.testing.assert_allclose(*out["pp_loss"], rtol=LOSS_TOL)
        for name, (g, gs) in out["pp_grads"].items():
            np.testing.assert_allclose(g, gs, atol=PP_GRAD_TOL * np.abs(gs).max() + 1e-12,
                                       err_msg=name)
        metas.append(set(out["pp_meta"]))
    # each stage holds half of each stack; together they hold all
    assert metas[0] and metas[1] and not metas[0] & metas[1]
    assert any(n.startswith("dec_blocks.0.") for n in metas[1])
    assert any(n.startswith("dec_blocks.3.") for n in metas[0])


def test_pipeline_train_step_equals_single_process(runs):
    """make_train_step(pipeline_group=...) over 2 stages of 2 micro-batches:
    the loss, the clip's norm over both stages' blocks, and each stage's
    gradients against the single-process step on one pass over the batch
    (WHOLE_GRAD_TOL); the stages hold disjoint blocks."""
    res, _, _ = runs
    held = [set(out["pp_step_held"]) for out in res[2]]
    assert not {n for n in held[0] & held[1] if "_blocks." in n}
    for out in res[2]:
        _same_step(out["pp_step"], grad_tol=WHOLE_GRAD_TOL,
                   norm_tol=WHOLE_GRAD_TOL, params=False)


def test_pipeline_scan_matches_serial_loop(runs):
    res, inp, _ = runs
    blocks = torch.nn.ModuleList(torch.nn.Linear(6, 6) for _ in range(4))
    blocks.load_state_dict(inp["scan_blocks"])
    x = inp["scan_x"].clone().requires_grad_(True)
    a, b, ys = x, x * 2, []
    for blk in blocks:
        a, b = torch.tanh(blk(a)) + b, b * 0.5
        ys.append(a)
    ys = torch.stack(ys)
    ((a ** 2).sum() + ys.sum()).backward()
    for out in res[2]:
        s = out["scan"]
        np.testing.assert_allclose(s["a"], a.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(s["b"], b.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(s["ys"], ys.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(s["gx"], x.grad.numpy(), atol=1e-5)
        for i, gw in s["gw"].items():
            np.testing.assert_allclose(gw, blocks[i].weight.grad.numpy(), atol=1e-5)
    assert sorted(res[2][0]["scan"]["gw"]) == [0, 1]


@pytest.mark.parametrize("route", ["tp", "sp"])
def test_tp_sp_forward_matches_jax(runs, route):
    """(2, 2) meshes: each data row's example against JAX's unsharded
    forward of the whole batch. SP splits N = 5 tokens (4 patches and the
    intrinsic token) over 2 ranks, so the padding shows."""
    res, _, refs = runs
    for r, out in enumerate(res[4]):
        _net_close(out[route], refs["net"], slice(r // 2, r // 2 + 1))
    assert res[4][0]["tp_qkv_rows"] == (72, 48)  # 2 of 4 heads' q, k, v


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_ep_moe_matches_jax(runs, mesh):
    """E = 4 experts, top-2, capacity factor 0.5 (48 routes for 4 x 6
    seats: routes overflow), tokens split over every rank, experts over the
    "expert" axis: each rank's rows and the aux loss against JAX's
    unsharded moe_mlp; and the same tokens with every expert on each rank,
    routed over the world (DDP's MoE)."""
    res, inp, refs = runs
    world = 2 if mesh == "1x2" else 4
    y_ref, aux_ref = (np.asarray(x) for x in refs["moe"])
    n = 24 // world
    for r, out in enumerate(res[world]):
        y, aux, local_shape = out[f"ep_{mesh}"]
        assert local_shape == (2, 16, 32)
        np.testing.assert_allclose(y, y_ref[r * n:(r + 1) * n], atol=MOE_TOL,
                                   rtol=MOE_TOL)
        np.testing.assert_allclose(aux, aux_ref, rtol=MOE_TOL)
        # DDP's route: all experts on each rank, routed over the world
        y, aux = out[f"tokens_{world}"]
        np.testing.assert_allclose(y, y_ref[r * n:(r + 1) * n], atol=MOE_TOL,
                                   rtol=MOE_TOL)
        np.testing.assert_allclose(aux, aux_ref, rtol=MOE_TOL)
