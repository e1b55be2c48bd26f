"""The port's lowering layer (a port of ``repro/lower``): DSE schedules
lowered into ExecutionPlans, the bucketed plan cache, and the serving
plan that picks each call's kernel path."""

from repro_torch.lower.cache import (HeadConfig, bucket_for,
                                     clear_plan_cache, head_config,
                                     kernel_plan, plan_cache_info,
                                     resolve_plan)
from repro_torch.lower.lowering import lower, lower_phase_plan, supported
from repro_torch.lower.plan import (DECODE_MEGAKERNEL, FUSED_ATTENTION,
                                    KERNEL_PATHS, QPROJ_ATTENTION,
                                    UNFUSED, BlockPlan, Downgrade,
                                    ExecutionPlan)
from repro_torch.lower.runtime import (PlanDispatch, ServingPlan,
                                       dispatch, impl_for, rung_down,
                                       serving_plan)

__all__ = ["DECODE_MEGAKERNEL", "FUSED_ATTENTION", "KERNEL_PATHS",
           "QPROJ_ATTENTION", "UNFUSED", "BlockPlan", "Downgrade",
           "ExecutionPlan", "lower", "lower_phase_plan", "supported",
           "bucket_for", "resolve_plan", "plan_cache_info",
           "clear_plan_cache", "HeadConfig", "head_config", "kernel_plan",
           "PlanDispatch", "ServingPlan", "dispatch", "impl_for",
           "rung_down", "serving_plan"]
