"""The paper's primary contribution: learning-efficiency-optimal joint
batchsize selection + communication resource allocation (Theorems 1/2,
Algorithm 1) and the FEEL period scheduler that applies it."""
from repro_torch.core.latency import (DeviceProfile, gradient_bits,
                                      period_latency, uplink_latency,
                                      downlink_latency)
from repro_torch.core.efficiency import (loss_decay, learning_efficiency,
                                         lr_scale, XiEstimator)
from repro_torch.core.solver import (solve_uplink, solve_downlink,
                                     solve_period, batch_closed_form,
                                     tau_closed_form, e_up_bounds, mu_bounds,
                                     fixed_slot_rows, FleetRows,
                                     UplinkSolution, DownlinkSolution,
                                     PeriodSolution)
from repro_torch.core.baselines import POLICIES, PolicyResult
from repro_torch.core.scheduler import (DevHorizon, DevScheduler,
                                        FeelScheduler, PeriodPlan,
                                        PlanHorizon, plan_horizons_batch)

__all__ = [
    "DeviceProfile", "gradient_bits", "period_latency", "uplink_latency",
    "downlink_latency", "loss_decay", "learning_efficiency", "lr_scale",
    "XiEstimator", "solve_uplink", "solve_downlink", "solve_period",
    "batch_closed_form", "tau_closed_form", "e_up_bounds", "mu_bounds",
    "fixed_slot_rows", "FleetRows", "UplinkSolution", "DownlinkSolution",
    "PeriodSolution", "POLICIES", "PolicyResult", "FeelScheduler",
    "PeriodPlan", "PlanHorizon", "plan_horizons_batch", "DevHorizon",
    "DevScheduler",
]
