"""The port's serving layer: the dense and paged continuous-batching
engines, the admission-controlled batcher and the page-pressure
policy."""

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
from repro_torch.serve.supervisor import PagePressurePolicy

__all__ = ["ContinuousBatchingEngine", "DecodeState", "OutOfPages",
           "PageAllocator", "PagedContinuousBatchingEngine",
           "PagedDecodeState", "PrefillResult", "PreemptedRequest",
           "chunked_prefill", "decode_step", "evict", "evict_paged",
           "greedy_sample", "init_decode_state",
           "init_paged_decode_state", "insert", "insert_paged",
           "make_serving_plan", "prefill", "prefill_request", "Request",
           "RequestBatcher", "PagePressurePolicy"]
