"""The port's serving layer: the dense and paged continuous-batching
engines, the admission-controlled batcher, and fault-tolerant serving
(fault injection, the supervisor and its page-pressure policy, the
state auditor, crash-safe snapshots)."""

from repro_torch.serve.engine import (ContinuousBatchingEngine, DecodeState,
                                      OutOfPages, PageAllocator,
                                      PagedContinuousBatchingEngine,
                                      PagedDecodeState, PrefillResult,
                                      PreemptedRequest, chunked_prefill,
                                      decode_step, evict, evict_paged,
                                      greedy_sample, init_decode_state,
                                      init_paged_decode_state, insert,
                                      insert_paged, make_serving_plan,
                                      prefill, prefill_request)
from repro_torch.serve.batcher import Request, RequestBatcher
from repro_torch.serve.audit import audit, audit_engine
from repro_torch.serve.faults import (FaultInjector, FaultSpec, Incident,
                                      IncidentLedger)
from repro_torch.serve.snapshot import restore_engine, snapshot_engine
from repro_torch.serve.supervisor import (PagePressurePolicy,
                                          ServingSupervisor)

__all__ = ["ContinuousBatchingEngine", "DecodeState", "OutOfPages",
           "PageAllocator", "PagedContinuousBatchingEngine",
           "PagedDecodeState", "PrefillResult", "PreemptedRequest",
           "chunked_prefill", "decode_step", "evict", "evict_paged",
           "greedy_sample", "init_decode_state",
           "init_paged_decode_state", "insert", "insert_paged",
           "make_serving_plan", "prefill", "prefill_request", "Request",
           "RequestBatcher", "audit", "audit_engine", "FaultInjector",
           "FaultSpec", "Incident", "IncidentLedger", "restore_engine",
           "snapshot_engine", "PagePressurePolicy", "ServingSupervisor"]
