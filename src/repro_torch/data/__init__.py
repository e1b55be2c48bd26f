"""Token data of the port (a copy of ``repro/data``)."""

from repro_torch.data.pipeline import (MemmapTokenDataset,
                                       SyntheticTokenDataset,
                                       make_batch_iterator)

__all__ = ["MemmapTokenDataset", "SyntheticTokenDataset",
           "make_batch_iterator"]
