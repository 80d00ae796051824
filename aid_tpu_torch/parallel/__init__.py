"""Frame parallelism and tensor parallelism over torch.distributed (see ``mesh``)."""

from aid_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    frame_axes,
    frame_shard_count,
    make_mesh,
    make_multislice_mesh,
    shard_frames,
    shard_params,
    sharded_denoise_sequence,
    sharded_denoise_steps,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "frame_axes",
    "frame_shard_count",
    "make_mesh",
    "make_multislice_mesh",
    "shard_frames",
    "shard_params",
    "sharded_denoise_sequence",
    "sharded_denoise_steps",
]
