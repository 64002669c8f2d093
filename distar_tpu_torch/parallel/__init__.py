from .grad_clip import GradClip, GradClipConfig, clip_activation, global_norm, leaf_norms
from .optimizer import Optimizer, build_optimizer

__all__ = ["GradClip", "GradClipConfig", "Optimizer", "build_optimizer", "clip_activation", "global_norm",
           "leaf_norms"]
