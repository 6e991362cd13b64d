from .mesh import (DATA_AXIS, TIME_AXIS, Mesh, batch_sharding, make_mesh,
                   replicated)
from .multihost import host_local_scenarios, init_multihost, measure_scaling
from .sharded import (SweepStats, sharded_batch_solve, sharded_horizon_solve,
                      sharded_receding_rollout, sharded_sweep,
                      time_sharded_riccati)

__all__ = [
    "make_mesh",
    "Mesh",
    "batch_sharding",
    "replicated",
    "DATA_AXIS",
    "TIME_AXIS",
    "sharded_sweep",
    "sharded_batch_solve",
    "SweepStats",
    "time_sharded_riccati",
    "sharded_horizon_solve",
    "sharded_receding_rollout",
    "init_multihost",
    "host_local_scenarios",
    "measure_scaling",
]
