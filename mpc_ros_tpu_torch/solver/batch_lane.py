"""Lane-major batched solver — the port's throughput path.

Counterpart of `mpc_ros_tpu/solver/batch_lane.py::batch_solve_lane`. The
public function keeps the JAX package's batch-major layout (z0s (B, 6),
coeffs (B, P), u_init (B, T, 2), a batch-major SolveResult); inside, every
array is batch-last, so the solve kernel reads coalesced rows.

Dispatch, as in the JAX package: f32, B % 128 == 0 and diff-drive go to
the whole-solve kernel — `backward="auto"` on a CUDA tensor (the
counterpart of running on the TPU) or `"mega"`. On the CPU, "auto" and
"mega" run the kernel's plain PyTorch version. The JAX package's XLA lane
path (`backward="xla"`), the legacy two-kernel route (`"pallas"`), blobs,
grid obstacle maps, per-knot setpoints, the bicycle family and f64 on
CUDA are not ported yet and raise NotImplementedError (ROADMAP).
"""

from __future__ import annotations

import torch

from ..config import SolverConfig
from ..kernels.pack import pack_params
from ..kernels.solve_mega import solve_mega_scheduled
from ..models.base import get_model
from .types import SolveResult


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


def lane_inputs(z0s: torch.Tensor, coeffs: torch.Tensor, p,
                cfg: SolverConfig, u_init=None):
    """The solve kernel's batch-last inputs from batch-major ones:
    zT (6, B), cT (P, B), params (12, B), lb/ub (2, B) from the model's
    control bounds, and u0 (T, 2, B) — zeros, or u_init (B, T, 2) clipped
    to the bounds."""
    dtype = z0s.dtype
    dev = z0s.device
    B = z0s.shape[0]
    T = cfg.n_controls
    zT = z0s.transpose(0, 1).contiguous()                 # (6, B)
    cT = coeffs.to(dtype).transpose(0, 1).contiguous()    # (P, B)
    blb, bub = get_model(cfg.model).control_bounds(p, dtype, dev)
    lb = (blb if blb.dim() == 2 else blb[:, None]).expand(2, B).contiguous()
    ub = (bub if bub.dim() == 2 else bub[:, None]).expand(2, B).contiguous()
    if u_init is None:
        us0 = torch.zeros((T, 2, B), dtype=dtype, device=dev)
    else:
        # u_init arrives batch-major (B, T, 2), clipped to the bounds
        u = torch.as_tensor(u_init, dtype=dtype, device=dev)
        us0 = torch.clamp(u.permute(1, 2, 0), lb[None],
                          ub[None]).contiguous()
    pp = pack_params(p, B, dtype, dev)
    return zT, cT, pp, lb, ub, us0


def batch_solve_lane(z0s: torch.Tensor, coeffs: torch.Tensor, p,
                     cfg: SolverConfig, u_init=None, omaps=None, blobs=None,
                     refs=None) -> SolveResult:
    """Lane-major batched solve. z0s (B, 6), coeffs (B, P); per-scenario
    MPCParams leaves of shape (B,) ride the lanes. Returns a batch-major
    SolveResult."""
    if omaps is not None:
        _not_ported("batch_solve_lane(omaps=...)", "ROADMAP Queue 1, item 9")
    if blobs is not None:
        _not_ported("batch_solve_lane(blobs=...)",
                    "ROADMAP Queue 2, K1 stage (e)")
    if refs is not None:
        _not_ported("batch_solve_lane(refs=...)",
                    "ROADMAP Queue 2, K1 stage (f)")
    if cfg.model == "bicycle":
        _not_ported("model='bicycle'", "ROADMAP Queue 2, K1 stage (g)")
    if cfg.model != "diff_drive":
        raise ValueError(
            f"batch_solve_lane supports the lane-specialized families, got "
            f"{cfg.model!r}")
    if cfg.backward in ("xla", "pallas"):
        _not_ported(f"backward={cfg.backward!r}",
                    "ROADMAP Queue 1, item 5 and Queue 2, K4/K5")
    if cfg.backward not in ("auto", "mega"):
        raise ValueError(f"unknown backward {cfg.backward!r}")

    dtype = z0s.dtype
    B = z0s.shape[0]
    on_cuda = z0s.device.type == "cuda"
    if on_cuda and not (dtype == torch.float32 and B % 128 == 0):
        # the kernel's dispatch rule; off it the JAX package runs the XLA
        # lane path, which is not ported
        _not_ported(f"a CUDA solve at dtype={dtype}, B={B} (the kernel "
                    f"takes float32 and B % 128 == 0)",
                    "ROADMAP Queue 1, item 5")
    zT, cT, pp, lb, ub, us0 = lane_inputs(z0s, coeffs, p, cfg, u_init)
    # CUDA tensors launch the kernel, CPU tensors run its plain version
    (ss_f, us_f, cost_f, conv_f, iters_f, gnorm_f, mu_f,
     _done) = solve_mega_scheduled(zT, cT, pp, lb, ub, us0, cfg)
    return SolveResult(
        us=us_f.permute(2, 0, 1),               # (B, T, 2)
        zs=ss_f[:, :6, :].permute(2, 0, 1),     # (B, N, 6)
        cost=cost_f,
        converged=conv_f > 0.5,
        n_iters=iters_f.to(torch.int32),
        grad_norm=gnorm_f,
        reg=mu_f,
    )
