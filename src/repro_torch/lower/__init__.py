"""The port's lowering layer: ExecutionPlan records, the bucketed plan
cache and the serving plan that picks each call's kernel path."""

from repro_torch.lower.plan import (DECODE_MEGAKERNEL, FUSED_ATTENTION,
                                    KERNEL_PATHS, QPROJ_ATTENTION,
                                    UNFUSED, ExecutionPlan)
from repro_torch.lower.cache import (bucket_for, clear_plan_cache,
                                     resolve_plan)
from repro_torch.lower.runtime import (PlanDispatch, ServingPlan,
                                       dispatch, impl_for, rung_down,
                                       serving_plan)

__all__ = ["DECODE_MEGAKERNEL", "FUSED_ATTENTION", "KERNEL_PATHS",
           "QPROJ_ATTENTION", "UNFUSED", "ExecutionPlan", "bucket_for",
           "clear_plan_cache",
           "resolve_plan", "PlanDispatch", "ServingPlan", "dispatch",
           "impl_for", "rung_down", "serving_plan"]
