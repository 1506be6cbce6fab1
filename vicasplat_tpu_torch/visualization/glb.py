"""Dependency-free GLB (binary glTF 2.0) export of a reconstructed scene
(a numpy copy of vicasplat_tpu/visualization/glb.py, byte for byte the
same file): a coloured point cloud of Gaussian centres plus one camera
marker per input view. A GLB is a JSON chunk and one binary buffer, so
this writes the container directly:

  - one POINTS primitive: POSITION (f32) + COLOR_0 (u8, normalized);
  - one LINES primitive per camera: an 8-segment frustum wireframe in the
    camera's color (cycling the reference's CAM_COLORS-style palette).

Output opens in standard glTF viewers (Blender, three.js, <model-viewer>).
"""
from __future__ import annotations

import json
import struct

import numpy as np

# camera wireframe colors, cycled per view
CAM_COLORS = [
    (255, 59, 48), (255, 149, 0), (255, 204, 0), (52, 199, 89),
    (0, 199, 190), (48, 176, 199), (50, 173, 230), (0, 122, 255),
    (88, 86, 214), (175, 82, 222), (255, 45, 85), (162, 132, 94),
]

_COMPONENT_F32 = 5126
_COMPONENT_U8 = 5121
_COMPONENT_U32 = 5125
_MODE_POINTS = 0
_MODE_LINES = 1
_TARGET_ARRAY_BUFFER = 34962
_TARGET_ELEMENT_ARRAY = 34963


def _frustum_lines(c2w: np.ndarray, focal: float, cam_size: float):
    """8-corner frustum wireframe (apex to image plane) in world space.

    Returns (vertices (5, 3) f32, segment index pairs (8, 2))."""
    w = cam_size
    h = cam_size * 0.75
    z = cam_size * float(focal) if focal else cam_size * 1.2
    # OpenCV-style camera: +z forward
    corners = np.array(
        [
            [0.0, 0.0, 0.0],
            [-w, -h, z], [w, -h, z], [w, h, z], [-w, h, z],
        ],
        dtype=np.float32,
    )
    R = c2w[:3, :3].astype(np.float32)
    t = c2w[:3, 3].astype(np.float32)
    verts = corners @ R.T + t
    segs = np.array(
        [[0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [2, 3], [3, 4], [4, 1]],
        dtype=np.uint32,
    )
    return verts, segs


def write_glb(
    path,
    points: np.ndarray,            # (N, 3) float
    colors: np.ndarray,            # (N, 3) float in [0, 1] or uint8
    camera_poses: np.ndarray | None = None,  # (V, 4, 4) c2w
    focal: float | None = None,    # normalized focal (z-depth of the plane)
    cam_size: float = 0.05,
) -> str:
    points = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 3))
    colors = np.asarray(colors)
    if colors.dtype != np.uint8:
        colors = np.clip(np.asarray(colors, np.float32), 0.0, 1.0)
        colors = (colors * 255.0 + 0.5).astype(np.uint8)
    colors = np.ascontiguousarray(colors.reshape(-1, 3))
    assert colors.shape[0] == points.shape[0]

    blob = bytearray()
    buffer_views = []
    accessors = []
    meshes = []
    nodes = []

    def _pad():
        while len(blob) % 4:
            blob.append(0)

    def _add_view(data: bytes, target: int) -> int:
        _pad()
        buffer_views.append(
            {"buffer": 0, "byteOffset": len(blob), "byteLength": len(data),
             "target": target}
        )
        blob.extend(data)
        return len(buffer_views) - 1

    def _add_accessor(view, comp, count, type_, normalized=False,
                      minmax=None) -> int:
        acc = {"bufferView": view, "componentType": comp, "count": count,
               "type": type_}
        if normalized:
            acc["normalized"] = True
        if minmax is not None:
            acc["min"], acc["max"] = minmax
        accessors.append(acc)
        return len(accessors) - 1

    # --- point cloud primitive ---
    pv = _add_view(points.tobytes(), _TARGET_ARRAY_BUFFER)
    pa = _add_accessor(
        pv, _COMPONENT_F32, points.shape[0], "VEC3",
        minmax=(points.min(0).tolist(), points.max(0).tolist()),
    )
    cv = _add_view(colors.tobytes(), _TARGET_ARRAY_BUFFER)
    ca = _add_accessor(cv, _COMPONENT_U8, colors.shape[0], "VEC3",
                       normalized=True)
    meshes.append(
        {"name": "gaussian_centers",
         "primitives": [{
             "attributes": {"POSITION": pa, "COLOR_0": ca},
             "mode": _MODE_POINTS,
         }]}
    )
    nodes.append({"mesh": 0, "name": "gaussian_centers"})

    # --- camera frusta ---
    if camera_poses is not None:
        camera_poses = np.asarray(camera_poses, np.float32).reshape(-1, 4, 4)
        for i, pose in enumerate(camera_poses):
            verts, segs = _frustum_lines(pose, focal, cam_size)
            col = np.tile(
                np.asarray(CAM_COLORS[i % len(CAM_COLORS)], np.uint8),
                (verts.shape[0], 1),
            )
            vv = _add_view(np.ascontiguousarray(verts).tobytes(),
                           _TARGET_ARRAY_BUFFER)
            va = _add_accessor(
                vv, _COMPONENT_F32, verts.shape[0], "VEC3",
                minmax=(verts.min(0).tolist(), verts.max(0).tolist()),
            )
            cvv = _add_view(np.ascontiguousarray(col).tobytes(),
                            _TARGET_ARRAY_BUFFER)
            cca = _add_accessor(cvv, _COMPONENT_U8, col.shape[0], "VEC3",
                                normalized=True)
            iv = _add_view(np.ascontiguousarray(segs).tobytes(),
                           _TARGET_ELEMENT_ARRAY)
            ia = _add_accessor(iv, _COMPONENT_U32, segs.size, "SCALAR")
            meshes.append(
                {"name": f"camera_{i}",
                 "primitives": [{
                     "attributes": {"POSITION": va, "COLOR_0": cca},
                     "indices": ia,
                     "mode": _MODE_LINES,
                 }]}
            )
            nodes.append({"mesh": len(meshes) - 1, "name": f"camera_{i}"})

    _pad()
    gltf = {
        # the JAX package's generator name: the two files are the same bytes
        "asset": {"version": "2.0", "generator": "vicasplat_tpu"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": buffer_views,
        "accessors": accessors,
    }
    js = json.dumps(gltf, separators=(",", ":")).encode()
    while len(js) % 4:
        js += b" "

    out = bytearray()
    total = 12 + 8 + len(js) + 8 + len(blob)
    out += struct.pack("<III", 0x46546C67, 2, total)       # 'glTF', v2
    out += struct.pack("<II", len(js), 0x4E4F534A) + js     # JSON chunk
    out += struct.pack("<II", len(blob), 0x004E4942) + blob  # BIN chunk
    with open(path, "wb") as f:
        f.write(out)
    return str(path)


def read_glb_json(path) -> dict:
    """Parse the JSON chunk of a GLB (for tests / inspection)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version, _ = struct.unpack_from("<III", data, 0)
    assert magic == 0x46546C67 and version == 2, "not a GLB v2 file"
    jlen, jtype = struct.unpack_from("<II", data, 12)
    assert jtype == 0x4E4F534A
    return json.loads(data[20:20 + jlen])
