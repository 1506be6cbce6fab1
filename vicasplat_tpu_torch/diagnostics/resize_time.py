"""Time the RE10K loader's resize of one flagship batch on the host, in one
tree of the repository, so that two trees can be compared in one session on
one machine:

    python vicasplat_tpu_torch/diagnostics/resize_time.py --root TREE --label NAME \
        [--out resize_time.jsonl]

One flagship batch is 2 examples x (8 context + 12 target) views: 40
frames of 360x640 (RE10K's frame size), resized to 455x256 (the short side
to 256, as `data/shims.rescale_and_crop_u8` does before its 256^2 crop).
TREE is the root of a checkout (this one, or an older commit unpacked with
git archive); its `vicasplat_tpu_torch` is the one timed. Appends one JSON
line to --out, each time the median of 3 after 1 warm-up:
- per_frame_s: the tree's `utils/image_io.resize_lanczos`, frame by frame
  (numpy in trees before the host library, the library on one thread
  after);
- batch_s and batch_1thread_s: the tree's `utils/host_image.resize_batch`
  over the whole batch on every core (as the loader calls it) and on one
  thread, or null where the tree has no such function;
- cores: os.cpu_count() of the machine.
The frames are uniform noise from numpy's default_rng(0); the resize's cost
does not depend on the pixels.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import sys
import time

import numpy as np

FRAMES, SRC_HW, SIZE = 40, (360, 640), (455, 256)


def _median_s(fn, reps: int = 3) -> float:
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True)
    p.add_argument("--label", required=True)
    p.add_argument("--out", default="resize_time.jsonl")
    args = p.parse_args(argv)
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import vicasplat_tpu_torch
    from vicasplat_tpu_torch.utils import image_io

    if pathlib.Path(vicasplat_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {vicasplat_tpu_torch.__file__}, not {root}'s")
    frames = np.random.default_rng(0).integers(0, 256, (FRAMES, *SRC_HW, 3), np.uint8)
    rec = dict(label=args.label, root=str(root), frames=FRAMES, src_hw=SRC_HW,
               size=SIZE, cores=os.cpu_count())
    rec["per_frame_s"] = _median_s(
        lambda: [image_io.resize_lanczos(f, SIZE) for f in frames])
    try:
        from vicasplat_tpu_torch.utils.host_image import resize_batch
    except ImportError:
        rec["batch_s"] = rec["batch_1thread_s"] = None
    else:
        rec["batch_s"] = _median_s(lambda: resize_batch(frames, SIZE))
        rec["batch_1thread_s"] = _median_s(lambda: resize_batch(frames, SIZE, n_threads=1))
    print(json.dumps(rec), flush=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
