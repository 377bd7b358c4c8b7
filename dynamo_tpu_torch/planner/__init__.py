"""The planner plane (port of dynamo_tpu/planner/): the single-pool
watermark and SLA planner, the two-pool fleet planner with its laws,
their observatory, perf profiles, the H100 calibration and the fleet
simulator."""

from dynamo_tpu_torch.planner.fleet import FleetPlanner, FleetPlannerConfig
from dynamo_tpu_torch.planner.obs import PLANNER_OBS, PlannerObservatory
from dynamo_tpu_torch.planner.planner import (
    Planner,
    PlannerConfig,
    SubprocessConnector,
    WorkerConnector,
)
from dynamo_tpu_torch.planner.pools import (
    DecodeLaw,
    FleetSample,
    PoolConfig,
    PrefillLaw,
    WorkerPool,
    default_pools,
)

__all__ = [
    "PLANNER_OBS",
    "DecodeLaw",
    "FleetPlanner",
    "FleetPlannerConfig",
    "FleetSample",
    "Planner",
    "PlannerConfig",
    "PlannerObservatory",
    "PoolConfig",
    "PrefillLaw",
    "SubprocessConnector",
    "WorkerConnector",
    "WorkerPool",
    "default_pools",
]
