from vrenderer_pathtracer.parallel.sharding import (
    SAMPLE_AXIS,
    TILE_AXIS,
    DeferredParams,
    TrainParams,
    make_render_mesh,
    replicate,
    shard_pixels,
    sharded_deferred_opt_step,
    sharded_opt_step,
    sharded_render_step,
    sharded_train_step,
)

__all__ = [
    "SAMPLE_AXIS",
    "TILE_AXIS",
    "DeferredParams",
    "TrainParams",
    "make_render_mesh",
    "replicate",
    "shard_pixels",
    "sharded_deferred_opt_step",
    "sharded_opt_step",
    "sharded_render_step",
    "sharded_train_step",
]
