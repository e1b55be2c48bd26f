"""Step 1 of Stream (paper Sec. II.C): split layers into fine-grained,
individually-schedulable computation nodes.

'To support the splitting of transpose and softmax layers into smaller
individually-schedulable computation nodes in Step 1, we create
computation nodes based on the top `for loop` of the temporal mapping:
one for each R if the top `for loop` is `for R` etc.'

For the attention workloads explored in the paper the optimal temporal
mapping puts R (output rows) outermost (Sec. IV.B.1), so nodes are
*row ranges of a layer's output*.  ``row_block`` controls granularity:
1 = one node per output row (the paper's finest split); larger blocks
trade trace resolution for evaluation speed — peak-memory results are
identical whenever frees/allocs are uniform across rows, which holds
for every layer type here.

Non-materialised ``Transpose`` layers are views: they produce no
computation nodes (the access pattern realises them); dependency
resolution handles the index remapping (see dependencies.py).

A copy of the JAX package's ``repro/core/nodes.py`` with its names and
arithmetic unchanged, so that the port's results are bit-equal to
the reference's; the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

from repro_torch.core import workload as wl


@dataclasses.dataclass(frozen=True)
class ComputationNode:
    """A schedulable unit: rows [row_start, row_end) of ``layer``'s output."""

    layer: str
    row_start: int
    row_end: int
    macs: int
    vector_ops: int
    simd: bool          # True -> runs on the SIMD unit beside the array

    @property
    def n_rows(self) -> int:
        return self.row_end - self.row_start

    def __repr__(self) -> str:  # compact for schedule dumps
        return f"<{self.layer}[{self.row_start}:{self.row_end}]>"


def is_simd_layer(layer: wl.Layer) -> bool:
    """Softmax / elementwise / layernorm run on the SIMD unit placed in
    parallel with the PE array (paper Sec. IV.B.1); matmuls run on the
    array; materialised transposes are data movement (SIMD timeline)."""
    return not isinstance(layer, wl.MatMul)


def split_layer(layer: wl.Layer, row_block: int = 1) -> list[ComputationNode]:
    """Split one layer into computation nodes along its top temporal loop
    (output rows).  Costs are apportioned exactly per row."""
    if isinstance(layer, wl.Transpose) and not layer.materialize:
        return []  # view — realised by the consumer's access pattern
    nodes = []
    total_rows = layer.rows
    macs_per_row = layer.macs() // max(total_rows, 1)
    vops_per_row = layer.vector_ops() // max(total_rows, 1)
    simd = is_simd_layer(layer)
    r = 0
    while r < total_rows:
        r1 = min(r + row_block, total_rows)
        nodes.append(ComputationNode(
            layer=layer.name, row_start=r, row_end=r1,
            macs=macs_per_row * (r1 - r),
            vector_ops=vops_per_row * (r1 - r),
            simd=simd,
        ))
        r = r1
    return nodes


def split_workload(workload: wl.Workload,
                   row_block: int = 1) -> dict[str, list[ComputationNode]]:
    """Step 1 over the whole graph: layer name -> ordered node list."""
    return {l.name: split_layer(l, row_block) for l in workload.topo_order()}


def iter_nodes(split: dict[str, list[ComputationNode]]) -> Iterator[ComputationNode]:
    for nodes in split.values():
        yield from nodes
