from .data import DataParallelStep
from .dryrun import dryrun_multicard
from .inference import (GatedStreamStep, make_gated_stream_step,
                        make_stream_step)
from .pipeline import PipelinedRTDETR, PipelinedYOLO
from .sharding import (ColumnParallelConv, Mesh, batch_sharding, make_mesh,
                       merge_shards, param_shardings, replicated,
                       shard_model)
from .spatial import make_spatial_forward, spatial_sharding

__all__ = ["make_mesh", "batch_sharding", "replicated", "param_shardings",
           "shard_model", "merge_shards", "Mesh", "ColumnParallelConv",
           "DataParallelStep", "make_stream_step", "make_gated_stream_step",
           "GatedStreamStep", "PipelinedYOLO", "PipelinedRTDETR",
           "make_spatial_forward", "spatial_sharding", "dryrun_multicard"]
