from .config import default_model_config, static_cfg, student_model_config
from .core import Model, gumbel_noise, init_params, noise_shapes

__all__ = [
    "Model",
    "default_model_config",
    "gumbel_noise",
    "init_params",
    "noise_shapes",
    "static_cfg",
    "student_model_config",
]
