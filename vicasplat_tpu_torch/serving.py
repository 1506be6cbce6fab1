"""Inference serving (port of vicasplat_tpu/serving.py): an engine with one
captured program per input shape, and a batch HTTP endpoint.

- Weights stay on the card in `dtype` (bfloat16 by default); with
  `quantize=True` the large linears are int8 (W8A8, `ops/quant.py`).
- `reconstruct` and `render` run one program per input shape, cached (at
  most 8 of each, as the JAX engine's `lru_cache`s of `jax.jit`). On a CUDA
  engine a program is a `torch.cuda.CUDAGraph` over static input buffers:
  its first call runs the function once eagerly on a side stream (every
  kernel built and loaded, cuBLAS warmed), then captures it; each call
  copies the inputs in, replays the graph and clones the outputs out, so a
  `SceneBatch` survives the next request. The kernels' launch counters do
  not move on a replay, so the launches counted during the capture are kept
  on the program. A capture that fails raises: nothing runs eagerly in its
  place. On a CPU engine a program is the eager call.
- `throughput()` replays the captured reconstruct back to back, timed by
  CUDA events, overhead-differenced as the JAX engine's in-jit loop is.

`python -m vicasplat_tpu_torch.serving --ckpt ... --port 8644` serves
POST /reconstruct (raw float32 clips in an npz) and POST
/reconstruct_video (long videos by sliding windows, `streaming.py`).
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import io
import json
import statistics
import threading
import time
from typing import Optional

import numpy as np
import torch

from .decoder.splatting import (
    DecoderSplattingConfig,
    _cov6,
    decoder_forward,
    flatten_gaussians,
)
from .geometry.se3 import rigid_inverse
from .kernels import launch_counts
from .models import (
    GaussianAdapterConfig,
    Gaussians,
    VicaNetConfig,
    VicaSplatConfig,
    init_vicasplat,
    vicasplat_forward,
)
from .models.vicasplat import normalize_images
from .ops.quant import SENSITIVE_PATHS, cast_tree_preserving_quant, quantize_tree
from .ops.rasterize.render import select_raster_config

PROGRAM_CACHE = 8  # programs kept per entry point, as JAX's lru_cache(maxsize=8)


@dataclasses.dataclass
class SceneBatch:
    """Device-resident reconstruction of a batch of videos."""
    gaussians: Gaussians              # (B, T, H, W, ...)
    poses: torch.Tensor               # (B, T, 4, 4) c2w, frame 0 = identity
    intrinsics: Optional[torch.Tensor]  # (B, T, 3, 3) when predicted
    # scene-adaptive rasterizer caps, chosen at the first render when the
    # engine runs with adaptive_caps=True (JAX `serving.py:47-56`: for
    # checkpoints trained with an unbounded rasterizer; checkpoints trained
    # through the capped renderer render worse with raised caps)
    raster_cfg: Optional[object] = None


def _leaves(tree) -> list:
    """The tensors of a tree of tuples and named tuples, None skipped."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in _leaves(x)]


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    items = [_tree_map(fn, x) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


class Program:
    """One entry point's program for one input shape.

    On a CPU device it is the eager call. On a CUDA device its first call
    captures a CUDA graph (after one eager warm-up on a side stream) over
    static copies of that call's inputs; every call copies its inputs into
    them, replays the graph and returns clones of the outputs.
    `launches` holds the kernel launches counted during the capture, which
    each replay repeats; `pool_bytes` the memory the capture reserved."""

    def __init__(self, fn, device: torch.device, capture: bool = True):
        self.fn = fn
        self.device = device
        self.capture = capture
        self.graph = None
        self.static_in = self.static_out = None
        self.launches: dict = {}
        self.pool_bytes = 0
        self.calls = 0

    def _capture(self, inputs):
        dev = self.device
        self.static_in = _tree_map(lambda x: x.detach().clone(), inputs)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn(*self.static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # as the capture does first: count its pool alone
        reserved = torch.cuda.memory_reserved(dev)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.static_out = self.fn(*self.static_in)
        self.graph = graph
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def __call__(self, *inputs):
        self.calls += 1
        if self.device.type != "cuda" or not self.capture:
            return self.fn(*inputs)
        if self.graph is None:
            self._capture(inputs)
        else:
            for dst, src in zip(_leaves(self.static_in), _leaves(inputs)):
                dst.copy_(src)
        self.graph.replay()
        return _tree_map(torch.clone, self.static_out)

    def replay(self, n: int):
        """n replays back to back on the current inputs (captured programs
        only): no copies in or out."""
        for _ in range(n):
            self.graph.replay()

    def release(self):
        """Free the graph and its memory pool (on eviction)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.static_in = self.static_out = None


class _ProgramCache:
    """Least recently used programs by key, at most `size`; an evicted
    program's graph and pool are freed."""

    def __init__(self, size: int = PROGRAM_CACHE):
        self.size = size
        self.items: collections.OrderedDict = collections.OrderedDict()

    def get(self, key, make):
        prog = self.items.get(key)
        if prog is None:
            prog = self.items[key] = make()
            while len(self.items) > self.size:
                self.items.popitem(last=False)[1].release()
        else:
            self.items.move_to_end(key)
        return prog


class InferenceEngine:
    """Shape-cached, `dtype`-resident VicaSplat inference."""

    def __init__(self, cfg: VicaSplatConfig, model=None, params=None,
                 ckpt: Optional[str] = None, dtype=torch.bfloat16,
                 decoder: DecoderSplattingConfig = DecoderSplattingConfig(),
                 view_mesh=None, quantize: bool = False,
                 quantize_min_size: Optional[int] = None,
                 quantize_exclude: Optional[tuple] = None,
                 adaptive_caps: bool = False, device="cuda"):
        """The weights come from `model` (a built `VicaSplat`, cast to
        `dtype` in place, or copied first when `quantize` is set), `params`
        (a JAX param tree, through `utils/weights.py`), `ckpt` (an npz read
        by `utils/checkpointing.load_weights`), or else random init from
        seed 0.

        quantize=True makes every linear of at least `quantize_min_size`
        weights int8 (W8A8), from the float weights, except the families
        whose path holds a `quantize_exclude` substring (default
        `quant.SENSITIVE_PATHS`, the center head; pass () to quantize
        all).

        view_mesh: a 1-D DeviceMesh (parallel.make_mesh) or process group:
        each render splits its views over the ranks
        (parallel/view_parallel.py) and every rank returns all of them.
        Every rank of the mesh must make the same calls; such a render runs
        eagerly, outside a CUDA graph, since the capture would hold the
        collective."""
        if sum(x is not None for x in (model, params, ckpt)) > 1:
            raise ValueError("pass at most one of model, params and ckpt")
        self.cfg = cfg
        self.dec_cfg = decoder
        self.view_mesh = view_mesh
        self.dtype = dtype
        self.adaptive_caps = adaptive_caps
        self.device = torch.device(device)
        if model is None:
            model = init_vicasplat(cfg, torch.Generator(self.device).manual_seed(0),
                                   self.device)
            if params is not None:
                from .utils.weights import load_jax_params

                load_jax_params(model, params)
            elif ckpt is not None:
                from .utils.checkpointing import load_weights

                load_weights(ckpt, model)
        elif quantize:
            model = copy.deepcopy(model)  # the caller's model stays float
        model = model.to(self.device)
        self.n_quantized = 0
        if quantize:
            kw = {} if quantize_min_size is None else {"min_size": quantize_min_size}
            kw["exclude"] = (SENSITIVE_PATHS if quantize_exclude is None
                             else tuple(quantize_exclude))
            model, self.n_quantized = quantize_tree(model, **kw)
        self.model = cast_tree_preserving_quant(model, dtype).eval()
        self._recon = _ProgramCache()
        self._render = _ProgramCache()
        # one request at a time: a capture must see no other work, and the
        # static buffers hold one request's inputs
        self._lock = threading.Lock()

    # ---- programs, cached per input shape ----

    def _reconstruct_raw(self):
        """The uncaptured reconstruct program."""
        def fn(images01, intrinsics):
            ctx = {"image": normalize_images(images01, self.cfg)}
            if intrinsics is not None:
                ctx["intrinsics"] = intrinsics
            out = vicasplat_forward(self.model, ctx, dtype=self.dtype)
            return (out["gaussians"], out["gaussian_camera_extrins"],
                    out["gaussian_camera_intrins"])

        return fn

    def _reconstruct_fn(self, shape, intrinsics_shape=None) -> Program:
        return self._recon.get((tuple(shape), intrinsics_shape),
                               lambda: Program(self._reconstruct_raw(), self.device))

    def _render_raw(self, image_shape, raster_cfg=None):
        """The uncaptured render program for a static output resolution."""
        dec_cfg = (self.dec_cfg if raster_cfg is None else
                   dataclasses.replace(self.dec_cfg, rasterize=raster_cfg))

        def fn(gaussians, extrinsics, intrinsics, near, far):
            if self.view_mesh is not None:
                from .parallel.view_parallel import decoder_forward_view_sharded

                return decoder_forward_view_sharded(
                    dec_cfg, gaussians, extrinsics, intrinsics, near, far,
                    image_shape, mesh=self.view_mesh)
            return decoder_forward(dec_cfg, gaussians, extrinsics, intrinsics,
                                   near, far, image_shape)

        return fn

    def _render_fn(self, vshape, image_shape, raster_cfg=None,
                   gaussian_shapes=None) -> Program:
        key = (tuple(vshape), tuple(image_shape), raster_cfg, gaussian_shapes)
        return self._render.get(
            key, lambda: Program(self._render_raw(tuple(image_shape), raster_cfg),
                                 self.device, capture=self.view_mesh is None))

    def _select_caps(self, scene: SceneBatch, extrinsics, intrinsics, image_shape):
        """Scene-level adaptive caps: the first view probed once, eagerly."""
        g = scene.gaussians
        if g.means.ndim > 3:
            g = flatten_gaussians(g)
        sh_degree = int(round(g.harmonics.shape[-1] ** 0.5)) - 1
        cov6 = _cov6(g)
        return select_raster_config(
            g.means[0].float(), cov6[0].float(), g.harmonics[0].float(),
            g.opacities[0].float(), rigid_inverse(extrinsics[0, 0].float()),
            intrinsics[0, 0].float(), tuple(image_shape), sh_degree,
            base=self.dec_cfg.rasterize)

    def _to_device(self, x):
        if x is None:
            return None
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()  # torch refuses to wrap a read-only array
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    # ---- public API ----

    def release(self):
        """Drop every cached program, freeing its graph and memory pool."""
        with self._lock:
            for cache in (self._recon, self._render):
                for prog in cache.items.values():
                    prog.release()
                cache.items.clear()

    @torch.no_grad()
    def reconstruct(self, images01, intrinsics=None) -> SceneBatch:
        """images01: (B, T, H, W, 3) float in [0, 1] (numpy or torch)."""
        images01 = self._to_device(images01)
        intrinsics = self._to_device(intrinsics)
        with self._lock:
            prog = self._reconstruct_fn(
                images01.shape, None if intrinsics is None else tuple(intrinsics.shape))
            g, poses, intr = prog(images01, intrinsics)
        return SceneBatch(gaussians=g, poses=poses, intrinsics=intr)

    @torch.no_grad()
    def render(self, scene: SceneBatch, extrinsics, intrinsics, image_shape,
               near=0.05, far=100.0):
        extrinsics = self._to_device(extrinsics)
        intrinsics = self._to_device(intrinsics)
        B, V = extrinsics.shape[:2]
        with self._lock:
            rcfg = None
            if self.adaptive_caps:
                if scene.raster_cfg is None:
                    scene.raster_cfg = self._select_caps(
                        scene, extrinsics, intrinsics, image_shape)
                rcfg = scene.raster_cfg
            gshapes = tuple(None if x is None else tuple(x.shape)
                            for x in scene.gaussians)
            prog = self._render_fn(extrinsics.shape, tuple(image_shape), rcfg, gshapes)
            return prog(scene.gaussians, extrinsics, intrinsics,
                        torch.full((B, V), near, device=self.device),
                        torch.full((B, V), far, device=self.device))

    @torch.no_grad()
    def throughput(self, images01, intrinsics=None, iters: int = 12) -> dict:
        """Scenes a second of the reconstruct program. On a CUDA engine, n
        replays of the captured graph back to back timed by CUDA events,
        (run(iters) - run(2)) / (iters - 2), so the fixed cost of a call
        cancels. On a CPU engine, the median of `iters` eager calls, each
        timed by the host's clock: a difference of two host timings can
        come out negative on a loaded host."""
        self.reconstruct(images01, intrinsics)  # captures on first use
        images01 = self._to_device(images01)
        intrinsics = self._to_device(intrinsics)
        with self._lock:
            prog = self._reconstruct_fn(
                images01.shape, None if intrinsics is None else tuple(intrinsics.shape))
            cuda = self.device.type == "cuda"

            def run(n):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                prog.replay(n)
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / 1e3

            def one_call():
                t0 = time.perf_counter()
                prog.fn(images01, intrinsics)
                return time.perf_counter() - t0

            if cuda:
                run(2), run(iters)
                dt = (run(iters) - run(2)) / (iters - 2)
            else:
                one_call()
                dt = statistics.median(one_call() for _ in range(iters))
        b = images01.shape[0]
        return {"latency_s": dt, "scenes_per_s": b / dt, "batch": b,
                "method": "cuda-graph-replay" if cuda else "eager"}


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------

def _decode_jpeg_payload(payload) -> np.ndarray:
    """A compressed request (JAX `serving.py:324-340`): the frames as one
    concatenated JPEG byte stream, `jpeg_sizes` a frame and `batch_shape`
    (B, T) -> (B, T, H, W, 3) float32 in [0, 1], decoded by the port's JPEG
    codec (a refused stream raises ValueError, answered 400)."""
    from .utils.host_image import decode_jpegs_u8

    sizes = payload["jpeg_sizes"].astype(np.int64)
    data = payload["jpeg_data"]
    ends = np.cumsum(sizes)
    u8 = decode_jpegs_u8([data[e - s:e] for s, e in zip(sizes, ends)])
    return u8.reshape(*tuple(payload["batch_shape"]), *u8.shape[1:]).astype(np.float32) / 255.0


def make_handler(engine: InferenceEngine):
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def _read_payload(self):
            length = int(self.headers["Content-Length"])
            return np.load(io.BytesIO(self.rfile.read(length)), allow_pickle=False)

        def _send_json(self, resp: dict, status: int = 200):
            body = json.dumps(resp).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            try:
                self._do_POST()
            except (ValueError, KeyError) as e:
                # a bad request (a missing field, fewer frames than the
                # window, ...) answers 400 with the message
                self._send_json({"error": f"{type(e).__name__}: {e}"}, status=400)

        def _do_POST(self):
            if self.path == "/reconstruct_video":
                from .streaming import reconstruct_video

                payload = self._read_payload()
                intr = payload["intrinsics"] if "intrinsics" in payload else None
                t0 = time.perf_counter()
                scene = reconstruct_video(
                    engine, payload["images"], intr,
                    window=int(payload["window"]) if "window" in payload else 8,
                    overlap=int(payload["overlap"]) if "overlap" in payload else 2)
                self._send_json({
                    "poses": scene.poses.tolist(),
                    "window_scales": scene.window_scales.tolist(),
                    "num_gaussians": int(np.prod(scene.gaussians.means.shape[:-1])),
                    "latency_s": time.perf_counter() - t0,
                })
                return
            if self.path != "/reconstruct":
                self.send_response(404)
                self.end_headers()
                return
            payload = self._read_payload()
            if "jpeg_data" in payload:
                images = _decode_jpeg_payload(payload)
            else:
                images = payload["images"]  # (B, T, H, W, 3) float32 in [0, 1]
            intr = payload["intrinsics"] if "intrinsics" in payload else None
            t0 = time.perf_counter()
            scene = engine.reconstruct(images, intr)
            poses = scene.poses.cpu().numpy()
            means = scene.gaussians.means.float().cpu().numpy()
            dt = time.perf_counter() - t0
            self._send_json({
                "poses": poses.tolist(),
                "num_gaussians": int(np.prod(means.shape[:-1])),
                "centers_mean": np.mean(means, axis=(1, 2, 3)).tolist(),
                "latency_s": dt,
            })

        def log_message(self, *a):
            pass

    return Handler


def serve(engine: InferenceEngine, port: int = 8644, block: bool = True):
    """Serve on 127.0.0.1:`port` (0 picks a free port: read it from the
    returned server's `server_address`). block=False returns the server,
    running on a daemon thread; stop it with `shutdown()` and
    `server_close()`."""
    import http.server

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), make_handler(engine))
    if block:
        print(f"serving on http://127.0.0.1:{srv.server_address[1]}/reconstruct")
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
        return None
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--port", type=int, default=8644)
    ap.add_argument("--quantize", action="store_true",
                    help="int8 W8A8 for the big linears (experimental; "
                         "validate accuracy per checkpoint)")
    ap.add_argument("--prune", type=float, default=0.0,
                    help="drop this fraction of lowest-opacity splats "
                         "before rendering (serving-throughput knob)")
    args = ap.parse_args(argv)
    cfg = VicaSplatConfig(backbone=VicaNetConfig(),
                          gaussian_adapter=GaussianAdapterConfig(sh_degree=4))
    dec = DecoderSplattingConfig(prune_fraction=args.prune)
    serve(InferenceEngine(cfg, ckpt=args.ckpt, quantize=args.quantize, decoder=dec),
          port=args.port)


if __name__ == "__main__":
    main()
