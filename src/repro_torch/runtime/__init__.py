"""Fault tolerance and elasticity of the port's training (a copy of
``repro/runtime``)."""

from repro_torch.runtime.elastic import (ElasticRunner, StepTimer,
                                         remesh_state, run_with_restarts)

__all__ = ["ElasticRunner", "StepTimer", "remesh_state",
           "run_with_restarts"]
