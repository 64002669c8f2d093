from .grad_clip import GradClip, GradClipConfig, clip_activation, global_norm, leaf_norms
from .optimizer import Optimizer, build_optimizer
from .mesh import (
    MeshConfigError,
    MeshSpec,
    batch_sharding,
    check_batch_divisible,
    fsdp_param_sharding,
    get_context_mesh,
    make_mesh,
    param_sharding,
    replicated_sharding,
    set_context_mesh,
)
from .ring_attention import ring_attention, ring_self_attention
from .feeder import ShardFeeder, assemble_global

__all__ = ["GradClip", "GradClipConfig", "MeshConfigError", "MeshSpec", "Optimizer", "ShardFeeder",
           "assemble_global", "batch_sharding", "build_optimizer", "check_batch_divisible",
           "clip_activation", "fsdp_param_sharding", "get_context_mesh", "global_norm", "leaf_norms",
           "make_mesh", "param_sharding", "replicated_sharding", "ring_attention", "ring_self_attention",
           "set_context_mesh"]
