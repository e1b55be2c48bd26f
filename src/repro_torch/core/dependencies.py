"""Step 2 of Stream (paper Sec. II.C + Fig. 3): fine-grained dependency
generation between computation nodes, extended with the transformer layer
types.

Per-type rules (paper Fig. 3), expressed on output row ranges:

* **MatMul** — output position (i, j) depends on the i-th row of the left
  input matrix and the j-th column of the right input matrix.  A node
  covering output rows [a, b) (all T columns — nodes split along R only)
  therefore needs rows [a, b) of I1 and *all* of I2.
* **Transpose** — output (i, j) depends on input (j, i); an output-row
  node touches one element of *every* input row, i.e. the whole input at
  row granularity.
* **Softmax** — output (i, j) depends on *all* input positions of row i
  (the denominator's row sum); the exponent is elementwise and adds no
  extra dependency.  A node covering rows [a, b) needs input rows [a, b).
* **Elementwise / LayerNorm** — rows [a, b) of each source (LayerNorm's
  row statistics stay within the row, like softmax).

Regions are either ``ALL`` or a half-open row interval.  The original
Stream uses an R-tree over hyper-rectangles; with row-range nodes the
regions are 1-D intervals, so direct interval arithmetic is exact and
equivalent (noted here for fidelity).

Non-materialised transposes are resolved as *views*: a consumer that
needs rows [a, b) of K^T really needs columns [a, b) of K — at row
granularity, all of K.

A copy of the JAX package's ``repro/core/dependencies.py`` with its names and
arithmetic unchanged, so that the port's results are bit-equal to
the reference's; the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.core import workload as wl

ALL = "ALL"
Region = Union[str, tuple[int, int]]   # ALL or (row_start, row_end)


def is_view(layer: wl.Layer) -> bool:
    """Non-materialised transposes are zero-copy views: no computation
    nodes, resolved through :func:`_resolve_view`."""
    return isinstance(layer, wl.Transpose) and not layer.materialize


def real_producers(workload: wl.Workload, name: str) -> list[str]:
    """Feature producers of ``name`` with views resolved to their
    sources; INPUT excluded, duplicates merged, order preserved."""
    out: list[str] = []
    for dep in workload.layers[name].feature_inputs():
        while dep != wl.INPUT and is_view(workload.layers[dep]):
            dep = workload.layers[dep].src
        if dep != wl.INPUT and dep not in out:
            out.append(dep)
    return out


def real_consumers(workload: wl.Workload, name: str) -> list[str]:
    """Consumer layer names of ``name`` with views expanded to *their*
    consumers (K -> K^T view -> QK^T), order preserved."""
    out: list[str] = []
    for c in workload.consumers(name):
        if is_view(c):
            out.extend(x.name for x in workload.consumers(c.name))
        else:
            out.append(c.name)
    return out


@dataclasses.dataclass(frozen=True)
class Requirement:
    """Consumer needs ``region`` of ``producer``'s output (or the network
    input when producer == workload.INPUT)."""

    producer: str
    region: Region


def _resolve_view(workload: wl.Workload, producer: str,
                  region: Region) -> Requirement:
    """Follow non-materialised transpose views down to a real tensor.
    Row range of a transposed view = column range of the source = ALL
    source rows at row granularity."""
    while producer != wl.INPUT:
        layer = workload.layers[producer]
        if isinstance(layer, wl.Transpose) and not layer.materialize:
            producer = layer.src
            region = ALL if region != ALL else ALL
            # any slice of a transpose view touches all source rows
            region = ALL
        else:
            break
    return Requirement(producer, region)


def required_inputs(workload: wl.Workload, layer_name: str,
                    row_start: int, row_end: int) -> list[Requirement]:
    """The regions of producer tensors a node covering output rows
    [row_start, row_end) must have available before it can execute."""
    layer = workload.layers[layer_name]
    reqs: list[Requirement] = []
    if isinstance(layer, wl.MatMul):
        if layer.i1 not in (wl.WEIGHT, wl.KVCACHE):
            reqs.append(_resolve_view(workload, layer.i1,
                                      (row_start, row_end)))
        if layer.i2 not in (wl.WEIGHT, wl.KVCACHE):
            reqs.append(_resolve_view(workload, layer.i2, ALL))
        # cache-append gates: whole-tensor completion dependencies on
        # the new K/V rows that must be in the cache before reading it
        for g in layer.gated_by:
            reqs.append(_resolve_view(workload, g, ALL))
    elif isinstance(layer, wl.Transpose):
        # materialised transpose: every output row reads a column of src
        reqs.append(_resolve_view(workload, layer.src, ALL))
    elif isinstance(layer, (wl.Softmax, wl.LayerNorm)):
        reqs.append(_resolve_view(workload, layer.src,
                                  (row_start, row_end)))
    elif isinstance(layer, wl.Elementwise):
        reqs.append(_resolve_view(workload, layer.src,
                                  (row_start, row_end)))
        if layer.src2 is not None:
            reqs.append(_resolve_view(workload, layer.src2,
                                      (row_start, row_end)))
    else:
        raise TypeError(f"unknown layer type {type(layer)}")
    # merge duplicate producers (e.g. residual of x with f(x))
    merged: dict[str, Region] = {}
    for r in reqs:
        cur = merged.get(r.producer)
        if cur is None:
            merged[r.producer] = r.region
        elif cur == ALL or r.region == ALL:
            merged[r.producer] = ALL
        else:
            merged[r.producer] = (min(cur[0], r.region[0]),
                                  max(cur[1], r.region[1]))
    return [Requirement(p, reg) for p, reg in merged.items()]


def consumer_row_counts(workload: wl.Workload,
                        row_block: int = 1) -> dict[str, list[int]]:
    """Liveness pre-pass: for every feature tensor (the network input and
    each layer output), how many consumer *nodes* still need each row.

    A row is freed from active-feature memory exactly when its count hits
    zero; workload outputs get a permanent +1 ('the dot at the end of the
    plots indicates that the output should remain active', Fig. 5).
    """
    counts: dict[str, list[int]] = {
        wl.INPUT: [0] * workload.input_rows,
    }
    for layer in workload.topo_order():
        counts[layer.name] = [0] * layer.rows

    def tensor_rows(name: str) -> int:
        if name == wl.INPUT:
            return workload.input_rows
        return workload.layers[name].rows

    for layer in workload.topo_order():
        if isinstance(layer, wl.Transpose) and not layer.materialize:
            continue  # views generate no nodes
        r = 0
        while r < layer.rows:
            r1 = min(r + row_block, layer.rows)
            for req in required_inputs(workload, layer.name, r, r1):
                rows = counts[req.producer]
                if req.region == ALL:
                    for i in range(len(rows)):
                        rows[i] += 1
                else:
                    for i in range(req.region[0], min(req.region[1],
                                                      len(rows))):
                        rows[i] += 1
            r = r1
    for out in workload.outputs:
        # resolve views so the keep-alive lands on a real tensor
        req = _resolve_view(workload, out, ALL)
        for i in range(len(counts[req.producer])):
            counts[req.producer][i] += 1
    return counts


def node_dependencies(workload: wl.Workload, split: dict[str, list],
                      layer_name: str, row_start: int,
                      row_end: int) -> list:
    """Explicit node->node edges (used by tests to validate the Fig. 3
    rules; the scheduler itself uses prefix-progress readiness which is
    equivalent for in-order row execution)."""
    deps = []
    for req in required_inputs(workload, layer_name, row_start, row_end):
        if req.producer == wl.INPUT:
            continue
        for node in split.get(req.producer, ()):
            if req.region == ALL or (node.row_start < req.region[1]
                                     and node.row_end > req.region[0]):
                deps.append(node)
    return deps
