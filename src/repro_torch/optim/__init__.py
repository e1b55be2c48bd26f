"""Optimizer of the port: AdamW, schedules, clipping and int8 gradient
compression with error feedback (copies of ``repro/optim``)."""

from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_schedule)
from repro_torch.optim.compression import (compress_decompress,
                                           error_feedback_init,
                                           int8_compress_with_feedback)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "compress_decompress", "error_feedback_init",
           "int8_compress_with_feedback"]
