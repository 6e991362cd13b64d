"""mpc_ros_tpu_torch — the PyTorch/CUDA port of the NMPC framework.

A second package beside the JAX reference `mpc_ros_tpu/`, with the same
module names. Plain tensor code is PyTorch; the whole-solve TPU kernel is a
hand-written CUDA kernel for Hopper (sm_90a) with a plain PyTorch version
beside it. CPU tensors run the plain versions; CUDA tensors launch the
kernels. The package never imports JAX.
"""

from .config import MPCParams, PlannerConfig, PlannerLimits, SolverConfig
from .config_io import (config_from_dict, config_to_dict, load_config,
                        save_config)

__version__ = "0.1.0"

__all__ = [
    "MPCParams",
    "SolverConfig",
    "PlannerConfig",
    "PlannerLimits",
    "config_from_dict",
    "config_to_dict",
    "load_config",
    "save_config",
]
