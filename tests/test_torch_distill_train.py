"""The port's train mode with distillation, on the CPU at toy size: the
synthetic_pose experiment with `train.distiller` set and its teacher read
from a DUSt3R checkpoint that the test writes (through
utils/ckpt_convert.py), crossing both phase boundaries."""
import numpy as np
import torch
from test_torch_ckpt_convert import _assert_state_equal, _dust3r_reference_sd, _tensors
from test_torch_distill import TEACHER, teacher_params

from vicasplat_tpu.models import dust3r as jd
from vicasplat_tpu_torch import main as tmain
from vicasplat_tpu_torch.models import dust3r as td
from vicasplat_tpu_torch.utils import checkpointing as tck

torch.set_num_threads(1)


def test_train_mode_with_a_converted_teacher(tmp_path, monkeypatch, capsys):
    """train(cfg, device="cpu") of the synthetic_pose experiment at toy size
    with its teacher read from a DUSt3R checkpoint at $DISTILLER_CKPT:
    steps 0, 1, 2 in "distill_only", "distill" and "full" (finite losses,
    the teacher's term in the first two only, no render in the first), the
    teacher's weights those of the file, none of them in the student."""
    from test_torch_train import TOY

    from vicasplat_tpu_torch.utils.config import parse_cli

    params = teacher_params(jd.Dust3RConfig(**TEACHER), seed=4)
    path = tmp_path / "mast3r.ckpt"
    torch.save({"model": _tensors(_dust3r_reference_sd(params))}, path)
    monkeypatch.setattr(tmain, "teacher_config", lambda cfg: td.Dust3RConfig(**TEACHER))
    monkeypatch.setenv("DISTILLER_CKPT", str(path))
    seen = []
    make = td.make_teacher_fn

    def keep(model, dtype):
        seen.append(model)
        return make(model, dtype)

    monkeypatch.setattr(td, "make_teacher_fn", keep)
    cfg = parse_cli(["+experiment=synthetic_pose", "mode=train", *TOY, "trainer.max_steps=3",
                     "trainer.val_check_interval=0", "wandb.mode=disabled",
                     "train.distiller=mast3r", "train.distill_only_steps=1",
                     "train.distill_max_steps=1", f"output_dir={tmp_path}",
                     f"checkpointing.output_dir={tmp_path}/ckpts"])
    r = tmain.train(cfg, device="cpu")
    assert f"loaded distiller weights from {path}" in capsys.readouterr().out
    _assert_state_equal(seen[0].state_dict(), params)
    logs = r["logs"]
    assert [x["step"] for x in logs] == [1, 2, 3]
    assert ["distillation" in x for x in logs] == [True, True, False]
    assert ["mse" in x for x in logs] == [False, True, True]
    assert logs[0]["psnr"] == 0.0  # the placeholder MSE of 1
    assert all(np.isfinite(v) for x in logs for v in x.values())
    assert not any(k.startswith(("head1", "head2")) for k in r["model"].state_dict())
    assert tck.load_weights(tmp_path / "ckpts/step_00000003.npz", r["model"]) == {
        "total_steps": 3}


def test_port_reproduces_the_distill_reference_on_the_cpu():
    """chip_smoke.py's `distill` reference: its recipes for the teacher's
    leaves and the batch equal tools/jax_distill_reference.py's, and the
    port's two float32 steps on the CPU match the committed JAX values
    within the card's own tolerance (DISTILL_TOL)."""
    import chip_smoke
    from tools import jax_distill_reference as tool

    assert chip_smoke.DISTILL_TEACHER == tool.TEACHER and chip_smoke.DISTILL_SEED == tool.SEED
    ours, theirs = chip_smoke.distill_reference_batch(), tool.reference_batch()
    for part in ("context", "target"):
        assert sorted(ours[part]) == sorted(theirs[part])
        for k in ours[part]:
            np.testing.assert_array_equal(ours[part][k], theirs[part][k])
    for path, shape in (("enc_blocks/attn/qkv/w", (2, 96, 288)), ("enc_norm/scale", (96,)),
                        ("head2/scratch1/w", (3, 3, 192, 256)), ("decoder_embed/b", (64,))):
        np.testing.assert_array_equal(chip_smoke.distill_teacher_leaf(path, shape),
                                      tool.teacher_leaf(path, shape))
    for want, ph, got, _ in chip_smoke.distill_reference_steps("cpu"):
        gaps, bad = chip_smoke.distill_gaps(want, ph, got)
        assert not bad, (want["step"], bad, got, want)
