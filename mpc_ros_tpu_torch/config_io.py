"""Config file I/O: typed, validated YAML loading and saving (counterpart
of `mpc_ros_tpu/config_io.py`, the same schemas, checks and errors).

Two accepted schemas:

1. **Canonical (nested)** — what `save_config` writes::

       mpc:      {w_cte: 100.0, ref_vel: 0.5, ...}      # MPCParams fields
       solver:   {n_steps: 20, max_sqp_iters: 60, ...}  # SolverConfig fields
       planner:  {delay_mode: true, limits: {xy_goal_tolerance: 0.2}, ...}

2. **Reference-compatible (flat)** — the key names of the reference's
   rosparam file (mpc_ros/params/mpc_params.yaml) and its
   dynamic_reconfigure schema (mpc_ros/cfg/MPCPlanner.cfg),
   so an existing deployment's param file loads unchanged. Both spellings
   are accepted (`mpc_w_cte` and `w_cte`). Reference keys that configured
   ROS plumbing we replaced (`pub_twist_cmd`, `waypoints_dist`) are
   accepted and ignored, mirroring how the reference itself never read
   most of that file (SURVEY.md §5.6: only `controller_frequency` was
   live).

Unknown keys are a hard error — the reference's string-keyed relay
silently dropped typos (e.g. a misspelled `mpc_w_vel` left the default in
place with no diagnostic); here they raise with the full unknown-key list.

Semantics carried over from the reference's live config path:

* `controller_freq` sets the control period `dt = 1/freq`
  (mpc_ros/src/mpc_planner_ros.cpp:57-70).
* `max_throttle` is clamped to >= 0.1
  (mpc_ros/src/driving_state.cpp:76-79).
* `mpc_steps` may arrive as a float (the reference cfg declares it
  double_t) and is truncated to int.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Optional, Tuple, Union

from .config import MPCParams, PlannerConfig, PlannerLimits, SolverConfig

ConfigTriple = Tuple[MPCParams, SolverConfig, PlannerConfig]

# reference flat key -> (section, field). `None` section = accepted+ignored
# (documented ROS plumbing with no equivalent here).
_REFERENCE_KEYS: dict[str, Optional[Tuple[str, str]]] = {
    # params/mpc_params.yaml + cfg/MPCPlanner.cfg solver block
    "mpc_steps": ("solver", "n_steps"),
    "steps": ("solver", "n_steps"),
    "mpc_ref_cte": ("mpc", "ref_cte"),
    "ref_cte": ("mpc", "ref_cte"),
    "mpc_ref_vel": ("mpc", "ref_vel"),
    "ref_vel": ("mpc", "ref_vel"),
    "mpc_ref_etheta": ("mpc", "ref_etheta"),
    "ref_etheta": ("mpc", "ref_etheta"),
    "mpc_w_cte": ("mpc", "w_cte"),
    "w_cte": ("mpc", "w_cte"),
    "mpc_w_etheta": ("mpc", "w_etheta"),
    "w_etheta": ("mpc", "w_etheta"),
    "mpc_w_vel": ("mpc", "w_vel"),
    "w_vel": ("mpc", "w_vel"),
    "mpc_w_angvel": ("mpc", "w_angvel"),
    "w_angvel": ("mpc", "w_angvel"),
    "mpc_w_angvel_d": ("mpc", "w_angvel_d"),
    "w_angvel_d": ("mpc", "w_angvel_d"),
    "mpc_w_accel": ("mpc", "w_accel"),
    "w_accel": ("mpc", "w_accel"),
    "mpc_w_accel_d": ("mpc", "w_accel_d"),
    "w_accel_d": ("mpc", "w_accel_d"),
    "mpc_max_angvel": ("mpc", "max_angvel"),
    "max_angvel": ("mpc", "max_angvel"),
    "mpc_max_throttle": ("mpc", "max_throttle"),
    "max_throttle": ("mpc", "max_throttle"),
    "mpc_bound_value": ("mpc", "bound_value"),
    "bound_value": ("mpc", "bound_value"),
    # control-loop block
    "controller_freq": ("special", "controller_freq"),
    "delay_mode": ("planner", "delay_mode"),
    "debug_info": ("planner", "debug_info"),
    "max_speed": ("planner", "max_speed"),
    "default_max_speed": ("planner", "max_speed"),
    "path_length": ("planner", "local_plan_length"),
    "goal_radius": ("limits", "xy_goal_tolerance"),
    "heading_yaw_error_threshold": ("planner", "heading_yaw_error_threshold"),
    # accepted + ignored (ROS plumbing replaced by the lifecycle API /
    # downsample_segments; the reference's waypoints_dist<0 meant
    # "computed by node", which is our only mode)
    "pub_twist_cmd": None,
    "waypoints_dist": None,
}

_MPC_FIELDS = {f.name for f in dataclasses.fields(MPCParams)}
_SOLVER_FIELDS = {f.name for f in dataclasses.fields(SolverConfig)}
_PLANNER_FIELDS = {f.name for f in dataclasses.fields(PlannerConfig)}
_LIMIT_FIELDS = {f.name for f in dataclasses.fields(PlannerLimits)}


def _validate(params: MPCParams, solver: SolverConfig,
              planner: PlannerConfig) -> None:
    errs = []
    if not 2 <= solver.n_steps <= 1000:
        errs.append(f"n_steps={solver.n_steps} outside [2, 1000]")
    if solver.max_sqp_iters < 1:
        errs.append(f"max_sqp_iters={solver.max_sqp_iters} < 1")
    if solver.ls_iters is not None and solver.ls_iters < 1:
        errs.append(f"ls_iters={solver.ls_iters} < 1")
    # `in (True, False)` would admit 0/1 via int==bool equality, and a
    # truthy non-bool slips past the engines' explicit-True guard rails
    if not (solver.ddp == "auto" or isinstance(solver.ddp, bool)):
        errs.append(f"ddp={solver.ddp!r} not in (True, False, 'auto')")
    if solver.mu_init != "auto" and not (
            isinstance(solver.mu_init, (int, float))
            and float(solver.mu_init) > 0):
        errs.append(f"mu_init={solver.mu_init!r} must be 'auto' or > 0")
    for name in ("w_cte", "w_etheta", "w_vel", "w_angvel", "w_accel",
                 "w_angvel_d", "w_accel_d"):
        v = getattr(params, name)
        if hasattr(v, "ndim") and v.ndim:     # per-scenario leaves: skip
            continue
        if float(v) < 0:
            errs.append(f"{name}={float(v)} < 0")
    for name in ("dt", "max_angvel", "max_throttle", "bound_value",
                 "lf", "max_steer"):
        v = getattr(params, name)
        if hasattr(v, "ndim") and v.ndim:
            continue
        if float(v) <= 0:
            errs.append(f"{name}={float(v)} <= 0")
    from .models import available_models

    if solver.model not in available_models():
        errs.append(f"model={solver.model!r} not in {available_models()}")
    if planner.max_speed < planner.min_speed:
        errs.append(f"max_speed={planner.max_speed} < "
                    f"min_speed={planner.min_speed}")
    if errs:
        raise ValueError("invalid config: " + "; ".join(errs))


def config_from_dict(data: Mapping[str, Any]) -> ConfigTriple:
    """Build (MPCParams, SolverConfig, PlannerConfig) from a dict in either
    the canonical nested schema or the reference's flat key schema (mixes
    are allowed; nested sections win over flat duplicates)."""
    mpc_kw: dict[str, Any] = {}
    solver_kw: dict[str, Any] = {}
    planner_kw: dict[str, Any] = {}
    limits_kw: dict[str, Any] = {}
    unknown = []

    flat = {k: v for k, v in data.items()
            if k not in ("mpc", "solver", "planner")}
    for key, val in flat.items():
        dest = _REFERENCE_KEYS.get(key, ...)
        if dest is ...:
            unknown.append(key)
            continue
        if dest is None:
            continue
        section, field = dest
        if section == "special":  # controller_freq -> dt
            if float(val) <= 0:
                raise ValueError(f"controller_freq={val} must be > 0")
            mpc_kw["dt"] = 1.0 / float(val)
        elif section == "mpc":
            mpc_kw[field] = val
        elif section == "solver":
            solver_kw[field] = val
        elif section == "planner":
            planner_kw[field] = val
        elif section == "limits":
            limits_kw[field] = val

    for section, sink, known in (("mpc", mpc_kw, _MPC_FIELDS),
                                 ("solver", solver_kw, _SOLVER_FIELDS),
                                 ("planner", planner_kw, _PLANNER_FIELDS)):
        sub = data.get(section) or {}
        for key, val in sub.items():
            if section == "planner" and key == "limits":
                for lk, lv in (val or {}).items():
                    if lk not in _LIMIT_FIELDS:
                        unknown.append(f"planner.limits.{lk}")
                    else:
                        limits_kw[lk] = lv
                continue
            if key not in known:
                unknown.append(f"{section}.{key}")
            else:
                sink[key] = val

    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")

    if "n_steps" in solver_kw:
        solver_kw["n_steps"] = int(float(solver_kw["n_steps"]))
    if "max_throttle" in mpc_kw:
        # reference clamp (mpc_ros/src/driving_state.cpp:76-79)
        mpc_kw["max_throttle"] = max(0.1, float(mpc_kw["max_throttle"]))
    # mu_init's default is now the string "auto", so _coerce's
    # default-type-driven float coercion no longer covers it — coerce
    # numeric strings (YAML 1.1 parses unsigned-exponent scalars like
    # `1e-6` as strings) explicitly, keeping "auto" verbatim
    if (isinstance(solver_kw.get("mu_init"), str)
            and solver_kw["mu_init"] != "auto"):
        try:
            solver_kw["mu_init"] = float(solver_kw["mu_init"])
        except ValueError:
            pass   # left as-is; _validate reports it loudly

    def _coerce(cls, kw):
        """Cast values to the field's default type: YAML 1.1 parses an
        unsigned-exponent scalar like `1e8` as the STRING '1e8' (its float
        regex wants a signed exponent), which would otherwise flow into
        the dataclass uncaught and fail later with an opaque error."""
        types = {f.name: type(f.default) for f in dataclasses.fields(cls)
                 if f.default is not dataclasses.MISSING}
        for k, v in kw.items():
            t = types.get(k)
            if t is float:
                kw[k] = float(v)
            elif t is int and not isinstance(v, bool):
                kw[k] = int(float(v))
            elif t is bool and isinstance(v, str):
                kw[k] = v.strip().lower() in ("1", "true", "yes", "on")
        return kw

    params = MPCParams(**{k: float(v) for k, v in mpc_kw.items()})
    solver = SolverConfig(**_coerce(SolverConfig, solver_kw))
    planner = PlannerConfig(limits=PlannerLimits(
        **_coerce(PlannerLimits, limits_kw)),
        **_coerce(PlannerConfig, planner_kw))
    _validate(params, solver, planner)
    return params, solver, planner


def load_config(path: Union[str, "os.PathLike[str]"]) -> ConfigTriple:
    """Load a YAML config file (canonical nested or reference flat schema)."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, Mapping):
        raise ValueError(f"{path}: top level must be a mapping")
    return config_from_dict(data)


def config_to_dict(params: MPCParams, solver: SolverConfig,
                   planner: PlannerConfig) -> dict:
    """Canonical nested dict (round-trips through config_from_dict)."""
    mpc = {f.name: float(getattr(params, f.name))
           for f in dataclasses.fields(params)}
    sol = {f.name: getattr(solver, f.name)
           for f in dataclasses.fields(solver)}
    pl = {f.name: getattr(planner, f.name)
          for f in dataclasses.fields(planner) if f.name != "limits"}
    pl["limits"] = {f.name: getattr(planner.limits, f.name)
                    for f in dataclasses.fields(planner.limits)}
    return {"mpc": mpc, "solver": sol, "planner": pl}


def save_config(path: Union[str, "os.PathLike[str]"], params: MPCParams,
                solver: SolverConfig, planner: PlannerConfig) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(config_to_dict(params, solver, planner), f,
                       sort_keys=True)
