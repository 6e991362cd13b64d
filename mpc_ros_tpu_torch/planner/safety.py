"""Failure detection and safe-stop supervision (counterpart of
`mpc_ros_tpu/planner/safety.py`; plain Python on the host).

The reference computes the solver status and then drives the robot with the
result regardless (quirk Q2), and silently tolerates solves that blow the
control period by 10x (SURVEY.md §5.3/§6). This monitor closes both gaps:

* per-cycle health checks: finite command, solver converged, solve time
  within budget;
* a consecutive-failure watchdog: after `max_consecutive_failures` bad
  cycles the monitor latches FAULT and commands a controlled stop
  (decelerate at the actuator limit, then zero);
* everything it decides is recorded (counts + last reason) for the
  observability layer.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class SafetyConfig:
    max_consecutive_failures: int = 3
    # solve wall-time budget as a fraction of the control period; the
    # reference's implicit budget was 5-10 periods (0.5 s cap vs 0.05/0.1 s)
    cycle_budget_frac: float = 1.0
    # an overrun this large counts as a FAILED cycle (stale command), not
    # just a statistic — persistent deadline blowouts must trip the
    # watchdog, which is exactly the gap the reference tolerated
    overrun_failure_frac: float = 3.0
    decel_limit: float = 1.0      # [m/s^2] used for the controlled stop


@dataclasses.dataclass
class SafetyStatus:
    healthy: bool = True
    fault: bool = False
    consecutive_failures: int = 0
    # worst failure streak observed over the run (the live streak resets to
    # 0 on success, so end-of-run assertions need the historical max)
    max_consecutive_failures: int = 0
    total_failures: int = 0
    overruns: int = 0
    last_reason: str = ""


class SafetyMonitor:
    """Wraps planner cycle outputs; returns the (possibly overridden)
    command."""

    def __init__(self, period_s: float, cfg: SafetyConfig = SafetyConfig()):
        self.period_s = period_s
        self.cfg = cfg
        self.status = SafetyStatus()
        self._last_v = 0.0

    def reset(self) -> None:
        self.status = SafetyStatus()
        self._last_v = 0.0

    def check(self, ok: bool, cmd: tuple[float, float],
              info=None) -> tuple[float, float]:
        """Validate one cycle. `info` is the planner CycleInfo (optional).
        Returns the command to apply (the input, or a safe-stop override).
        """
        v, w = cmd
        reason = ""
        if not ok:
            reason = "planner reported failure"
        elif not (math.isfinite(v) and math.isfinite(w)):
            reason = "non-finite command"
        elif info is not None and info.tracking is not None \
                and info.tracking.solve is not None \
                and not bool(info.tracking.solve.converged):
            reason = "solver not converged"
        if info is not None and info.solve_time_s > (
                self.cfg.cycle_budget_frac * self.period_s):
            self.status.overruns += 1
            if not reason and info.solve_time_s > (
                    self.cfg.overrun_failure_frac * self.period_s):
                # the command being applied is already several periods old
                reason = "solve-time budget blown"

        st = self.status
        if reason:
            st.consecutive_failures += 1
            st.max_consecutive_failures = max(
                st.max_consecutive_failures, st.consecutive_failures)
            st.total_failures += 1
            st.last_reason = reason
            st.healthy = False
            if st.consecutive_failures >= self.cfg.max_consecutive_failures:
                st.fault = True
        else:
            st.consecutive_failures = 0
            st.healthy = True

        if st.fault or reason:
            # controlled stop: bleed |speed| toward zero at the decel limit
            # (sign-preserving — a reversing robot ramps to rest instead of
            # halting instantaneously), zero rotation
            step = self.cfg.decel_limit * self.period_s
            mag = max(abs(self._last_v) - step, 0.0)
            v_safe = mag if self._last_v >= 0.0 else -mag
            self._last_v = v_safe
            return (v_safe, 0.0)
        self._last_v = v
        return (v, w)

    def clear_fault(self) -> None:
        """Operator acknowledgment — re-arm after a latched fault."""
        self.status.fault = False
        self.status.consecutive_failures = 0
