"""Hand-written CUDA kernels (`csrc/`), their plain PyTorch versions, the
build that compiles them at first use, and the roofline accounting."""
from .roofline import (DeviceSpec, StageAccount, account_backward,
                       account_forward, account_linearize, account_rollout,
                       efficiency, megakernel_accounting, solve_accounting)

__all__ = [
    "DeviceSpec",
    "StageAccount",
    "account_backward",
    "account_forward",
    "account_linearize",
    "account_rollout",
    "efficiency",
    "megakernel_accounting",
    "solve_accounting",
]
