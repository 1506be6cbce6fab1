"""Parallelism over torch.distributed (port of vicasplat_tpu/parallel):
data parallelism (DDP in training/step.py, FSDP2), view-sharded rendering,
tensor, sequence and pipeline parallelism, and expert parallelism."""
from .mesh import make_mesh, replicate, shard_batch  # noqa: F401
from .pp import (  # noqa: F401
    make_mesh_pipe,
    make_mesh_pipe_data,
    pipeline_scan,
    shard_params_pp,
)
from .ep import make_mesh_ep, shard_params_ep  # noqa: F401
from .sp import (  # noqa: F401
    make_mesh_sp,
    sp_shard_batch_only,
    sp_shard_tokens,
)
from .tp import make_mesh_2d, shard_params_tp  # noqa: F401
from .view_parallel import decoder_forward_view_sharded  # noqa: F401
