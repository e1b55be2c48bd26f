"""Fault tolerance of the port's training (a copy of the single-device
half of ``repro/runtime``)."""

from repro_torch.runtime.elastic import StepTimer, run_with_restarts

__all__ = ["StepTimer", "run_with_restarts"]
