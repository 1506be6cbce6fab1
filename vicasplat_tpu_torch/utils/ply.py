"""3DGS PLY export and its reader, binary little-endian (a numpy copy of
vicasplat_tpu/utils/ply.py:15-119): opacity pruning at 0.005, xyzw -> wxyz
quaternions, f_dc / f_rest split, log scales and inverse-sigmoid
opacities, the standard layout of 3DGS viewers."""
from __future__ import annotations

import pathlib

import numpy as np


def export_ply(
    means: np.ndarray,        # (N, 3)
    scales: np.ndarray,       # (N, 3) linear scales
    rotations: np.ndarray,    # (N, 4) xyzw
    harmonics: np.ndarray,    # (N, 3, d_sh)
    opacities: np.ndarray,    # (N,)
    path: str | pathlib.Path,
    opacity_threshold: float = 0.005,
    shift_and_scale: bool = False,
):
    means = np.asarray(means, np.float32)
    scales = np.asarray(scales, np.float32)
    rotations = np.asarray(rotations, np.float32)
    harmonics = np.asarray(harmonics, np.float32)
    opacities = np.asarray(opacities, np.float32)

    if shift_and_scale:
        center = np.median(means, axis=0)
        means = means - center
        spread = np.median(np.abs(means), axis=0).mean()
        if spread > 0:
            means = means / spread
            scales = scales / spread

    keep = opacities >= opacity_threshold
    order = np.argsort(-opacities[keep])

    means = means[keep][order]
    scales = scales[keep][order]
    rotations = rotations[keep][order][:, [3, 0, 1, 2]]  # xyzw -> wxyz
    harmonics = harmonics[keep][order]
    opacities = opacities[keep][order]

    n, _, d_sh = harmonics.shape
    f_dc = harmonics[:, :, 0]                      # (N, 3)
    f_rest = harmonics[:, :, 1:].reshape(n, -1)    # (N, 3*(d_sh-1)), rgb-major

    eps = 1e-8
    log_scales = np.log(np.clip(scales, eps, None))
    inv_sig_op = np.log(
        np.clip(opacities, eps, 1 - eps) / np.clip(1 - opacities, eps, None)
    )

    fields = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    data = np.concatenate(
        [
            means,
            np.zeros_like(means),  # normals
            f_dc,
            f_rest,
            inv_sig_op[:, None],
            log_scales,
            rotations,
        ],
        axis=1,
    ).astype("<f4")

    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {f}\n" for f in fields)
        + "end_header\n"
    )
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())
    return int(n)


def read_ply(path: str | pathlib.Path) -> dict:
    """The layout above -> {means, scales, rotations (xyzw), harmonics,
    opacities} (round trips, the viewer)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode("ascii").splitlines()
        n = int(next(l for l in lines if l.startswith("element vertex")).split()[-1])
        fields = [l.split()[-1] for l in lines if l.startswith("property")]
        data = np.frombuffer(f.read(), dtype="<f4").reshape(n, len(fields))
    cols = {name: data[:, i] for i, name in enumerate(fields)}
    d_rest = sum(1 for f in fields if f.startswith("f_rest_"))
    d_sh = 1 + d_rest // 3
    sh = np.zeros((n, 3, d_sh), np.float32)
    for c in range(3):
        sh[:, c, 0] = cols[f"f_dc_{c}"]
    rest = np.stack([cols[f"f_rest_{i}"] for i in range(d_rest)], axis=1)
    sh[:, :, 1:] = rest.reshape(n, 3, d_sh - 1)
    return {
        "means": np.stack([cols["x"], cols["y"], cols["z"]], axis=1),
        "scales": np.exp(np.stack([cols[f"scale_{i}"] for i in range(3)], axis=1)),
        "rotations": np.stack([cols[f"rot_{i}"] for i in range(4)], axis=1)[
            :, [1, 2, 3, 0]
        ],  # wxyz -> xyzw
        "harmonics": sh,
        "opacities": 1 / (1 + np.exp(-cols["opacity"])),
    }
