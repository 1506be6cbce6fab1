"""`python -m vicasplat_tpu_torch.multichip` on the CPU: four gloo ranks at
toy widths run every route of the card's run (DDP, FSDP2, TP 1 x 4 and
2 x 2, SP, EP, GPipe, the view-sharded render, main.py's train mode with a
checkpoint and a resume), each held by the script against world 1 at its
stated tolerances; and its refusal to run without the cards it is asked
for."""
import json
import os
import subprocess
import sys

import pytest
import torch

from vicasplat_tpu_torch import multichip
from vicasplat_tpu_torch.diagnostics import holds

torch.set_num_threads(1)

ROOT = multichip.ROOT


def test_world4_on_gloo_against_world1():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "vicasplat_tpu_torch.multichip",
                           "--device", "cpu", "--world", "4"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 0 and last["ok"], proc.stdout[-6000:] + proc.stderr[-3000:]
    summary = json.loads((multichip.OUT / "summary.json").read_text())
    res = summary["results"]
    assert summary["failures"] == [] and set(res) == {"ref", "b", "c", "d", "e", "f",
                                                      "g", "h", "i"}
    # every route's rows, as the script held them: the flagship's loss
    # within FLASH_BWD_FLOOR of world 1, the float32 witness's loss within
    # STEP_TOL and its norms and updates within FLASH_BWD_FLOOR
    routes = {"b": ("flagship", "witness"), "c": ("flagship", "witness"),
              "d": ("1x4", "1x4 witness", "2x2", "2x2 witness"),
              "e": ("flagship", "witness"), "f": ("flagship", "witness"),
              "g": ("flagship", "witness")}
    for phase, rows in routes.items():
        for name in rows:
            row = res[phase][name]
            tol = holds.STEP_TOL if "witness" in name else holds.FLASH_BWD_FLOOR
            assert row["gaps"]["loss"] <= tol, (phase, name, row["gaps"])
            worst, gap, held_tol = row["worst_held"]
            assert gap <= held_tol, (phase, name, row["worst_held"])
            assert len(row["ms"]) == 4
    assert res["h"]["bitwise"] and res["h"]["views"] == 2
    train = res["i"]
    assert [x["step"] for x in train["logs"]] == [1, 2, 3, 4]
    assert train["checkpoints"] == ["step_00000002.npz"]
    for k, tol in holds.TRAIN_LOSS_TOL.items():
        assert train["worst"][k] <= tol, (k, train["worst"])
    # in the config's bf16, the group's steps are world 1's in micro-batches
    # of a rank's size, to float32 sums in another order (the same frames:
    # the script checks each step's); the whole batch rounds otherwise
    assert train["worst"]["grad_norm"] < 1e-5 and train["worst"]["loss"] < 1e-5, train
    # the logged PSNR is the PSNR of the batch's MSE, as world 1 on the
    # whole batch logs it (the mean of the four ranks' PSNRs was 3.3e-2 dB
    # off, F9); under accumulation JAX and the port log the micro-batches'
    # mean PSNR
    assert train["vs_whole"]["psnr"] < 1e-4, train["vs_whole"]
    # the FSDP2 row beside the memory reckoning's world-4 layouts
    assert set(res["c"]["reckoning_gib"]) == {"fsdp4", "dp4"}
    assert res["c"]["reckoning_gib"]["fsdp4"] < res["c"]["reckoning_gib"]["dp4"]


def test_refuses_more_cards_than_exist(monkeypatch, capsys):
    """Asked for more cards than the machine has, the script exits 2 before
    it starts anything; without a card at all, too (in a child process with
    no visible card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    started = []
    monkeypatch.setattr(multichip, "_run_ranks", lambda *a: started.append(a))
    assert multichip.main(["--world", "4"]) == 2
    assert not started
    assert "needs 4 cards, 2 found" in capsys.readouterr().err
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "vicasplat_tpu_torch.multichip"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and '"ok"' not in proc.stdout


@pytest.mark.parametrize("name,want", [("dp4", {"data": 4}), ("fsdp4", {"data": 4}),
                                       ("pp4", {"pipe": 4, "data": 1}),
                                       ("pp4xdp2", {"pipe": 4, "data": 2})])
def test_memory_reckoning_layouts(name, want):
    """reckon's layouts by name: the data ways or the stages, and the state
    a rank between FSDP2's and replication's."""
    from vicasplat_tpu_torch.parallel.memory_proof import reckon

    rows = reckon(configs=(name, "dp4"))["configs"]
    assert rows[name]["mesh"] == want
    assert 0 < rows[name]["state_bytes"] <= rows["dp4"]["state_bytes"]
    with pytest.raises(ValueError):
        reckon(configs=("tp4",))
