"""Workload graph: the transformer layer types the paper adds to Stream.

A ``Workload`` is a DAG of layers.  The attention head (paper Fig. 1)
is described with 7 layers: 5 matrix-matrix multiplications (3x
features x weights for Q/K/V, 2x features x features for QK^T and
QK^T.V), one transpose and one (row-wise) softmax.

Matmul dimension convention follows the paper (Sec. II.A):
    I1 (R x S)  @  I2 (S x T)  ->  O (R x T)
so for Q/K/V:  R=M, S=T=N;  for QK^T: R=T=M, S=N;  for (QK^T)V:
R=S=M, T=N.

Beyond the paper's single head, builders cover full transformer-block
workloads: ``ffn`` (dense and GLU variants), ``gqa_attention``
(grouped-query attention — query heads share K/V tensors per KV group),
``transformer_block`` (pre/post-norm with residual adds) and
``from_model_config`` which bridges any ``models.common.ModelConfig``
(the architectures registered in ``repro_torch.configs.ARCHS``) into a DSE
workload of one block at a given sequence length.

A copy of the JAX package's ``repro/core/workload.py`` with its names and
arithmetic unchanged, so that the port's results are bit-equal to
the reference's; the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Optional

# Operand tags
INPUT = "__input__"       # network input feature map
WEIGHT = "__weight__"     # constant weights (not active *feature* data)
KVCACHE = "__kv_cache__"  # persistent KV-cache operand (decode phase):
#                           like WEIGHT it is not active feature data,
#                           but its footprint is tracked separately as
#                           Workload.kv_cache_words and its reads come
#                           from the top memory level (the cache does
#                           not fit the multi-banked L1)

#: Inference phases a workload can model.  ``prefill`` processes the
#: whole prompt (M = seq_len); ``decode`` processes M = 1..few new
#: tokens against an ``n_ctx``-deep persistent KV cache.
PHASES = ("prefill", "decode")


@dataclasses.dataclass(frozen=True)
class Layer:
    """Base layer: produces one output tensor of shape (rows, cols)."""

    name: str
    rows: int
    cols: int

    @property
    def out_words(self) -> int:
        return self.rows * self.cols

    def feature_inputs(self) -> tuple[str, ...]:
        raise NotImplementedError

    def macs(self) -> int:
        return 0

    def vector_ops(self) -> int:
        return 0

    def weight_words(self) -> int:
        """Words of constant weights the layer reads (non-zero only for
        weight-operand matmuls)."""
        return 0


@dataclasses.dataclass(frozen=True)
class MatMul(Layer):
    """O(R,T) = I1(R,S) @ I2(S,T).  rows=R, cols=T.

    ``i1`` names the producing layer or INPUT / WEIGHT; ``i2`` may
    additionally be KVCACHE.  The paper's novelty is supporting i2 as
    a *feature* operand (QK^T and QK^T.V), not only weights.
    ``i2=KVCACHE`` models the decode-phase variant where the right
    operand is the persistent KV cache: no feature dependency, no
    active-memory occupancy, reads charged against the top memory
    level.  A cached *left* operand never occurs in transformer
    decode (the fresh Q / softmax rows are always the left input), so
    ``i1=KVCACHE`` is rejected rather than half-supported.

    ``gated_by`` lists layers whose *completion* must precede this
    matmul without their output being a live feature operand — used to
    order a cached score matmul after the cache-append projections
    (the new token's K/V row must be in the cache before QK^T reads
    it).  Gated producers are whole-tensor (ALL-region) dependencies.
    """

    s: int = 0
    i1: str = INPUT
    i2: str = WEIGHT
    gated_by: tuple[str, ...] = ()

    def __post_init__(self):
        if self.i1 == KVCACHE:
            raise ValueError(
                f"{self.name}: KVCACHE is only supported as the right "
                "operand i2 (the cost model prices cache reads there)")

    @property
    def r(self) -> int:
        return self.rows

    @property
    def t(self) -> int:
        return self.cols

    def feature_inputs(self) -> tuple[str, ...]:
        out = []
        if self.i1 not in (WEIGHT, KVCACHE):
            out.append(self.i1)
        if self.i2 not in (WEIGHT, KVCACHE):
            out.append(self.i2)
        out.extend(self.gated_by)
        return tuple(out)

    def macs(self) -> int:
        return self.rows * self.s * self.cols

    def weight_words(self) -> int:
        """Words of constant weights this layer reads (0 unless i2 is
        WEIGHT) — the unit the engine's block-switch reload charge is
        denominated in."""
        return self.s * self.cols if self.i2 == WEIGHT else 0


@dataclasses.dataclass(frozen=True)
class Transpose(Layer):
    """O(i,j) = I(j,i).  Input shape is (cols, rows).

    ``materialize=False`` treats the transpose as a zero-copy view (the
    paper's Fig. 5 traces count K and K^T as one tensor; on most
    accelerators the transpose is realised by the access pattern).  The
    dependency rule of Sec. II.C is modelled either way.
    """

    src: str = INPUT
    materialize: bool = False

    def feature_inputs(self) -> tuple[str, ...]:
        return (self.src,)

    def vector_ops(self) -> int:
        return self.out_words if self.materialize else 0


@dataclasses.dataclass(frozen=True)
class Softmax(Layer):
    """Row-wise softmax (paper Eq. 2): O(i,j) depends on ALL of input row i
    (denominator), while exp() itself is elementwise."""

    src: str = INPUT

    def feature_inputs(self) -> tuple[str, ...]:
        return (self.src,)

    def vector_ops(self) -> int:
        # exp + sum + divide per element ~ 3 vector ops / element
        return 3 * self.out_words


@dataclasses.dataclass(frozen=True)
class Elementwise(Layer):
    """Pointwise op (requant / GELU / residual-add): O(i,j) <- f(I(i,j))."""

    src: str = INPUT
    src2: Optional[str] = None
    ops_per_element: int = 1

    def feature_inputs(self) -> tuple[str, ...]:
        return (self.src,) if self.src2 is None else (self.src, self.src2)

    def vector_ops(self) -> int:
        return self.ops_per_element * self.out_words


@dataclasses.dataclass(frozen=True)
class LayerNorm(Layer):
    """Row-wise normalisation: like softmax, O(i, j) depends on all of
    input row i (mean/variance), plus elementwise scale."""

    src: str = INPUT

    def feature_inputs(self) -> tuple[str, ...]:
        return (self.src,)

    def vector_ops(self) -> int:
        return 4 * self.out_words


@dataclasses.dataclass
class Workload:
    """A DAG of layers with a single external feature input of shape
    (input_rows, input_cols).

    Phase/network metadata (all default-empty, so single-block prefill
    workloads behave exactly as before):

    * ``cache_layers`` — layers whose outputs are written to the
      persistent KV cache instead of active feature memory (the new
      token's K/V projections in decode).  The engine never allocates
      them in L1.
    * ``kv_cache_words`` — static KV-cache footprint in words (the
      N_ctx-deep K and V tensors per KV head), reported separately
      from the active-feature peak on ``Result.kv_cache_words``.
    * ``block_of`` — layer name -> block index for multi-block
      networks; the engine charges weight-reload traffic when a core
      switches blocks.  Layers absent from the map are block 0.
    * ``period_prefixes`` — per-block name prefixes of a
      block-periodic network (set by :func:`network`); the schedule
      generator explores one block's sub-space and replicates it
      instead of re-enumerating every block.
    """

    name: str
    input_rows: int
    input_cols: int
    layers: dict[str, Layer] = dataclasses.field(default_factory=dict)
    # layers whose outputs must stay live at the end (feed the next block;
    # the 'dot at the end' of the paper's Fig. 5 plots).
    outputs: tuple[str, ...] = ()
    cache_layers: set[str] = dataclasses.field(default_factory=set)
    kv_cache_words: int = 0
    block_of: dict[str, int] = dataclasses.field(default_factory=dict)
    period_prefixes: tuple[str, ...] = ()
    # consumer adjacency, maintained by add(): producer name (or INPUT)
    # -> consumer layer names in insertion order.  Precomputed so the
    # scheduling loops' consumers() lookups are O(degree), not O(L).
    _consumer_names: dict[str, list[str]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        self._consumer_names.clear()
        for layer in self.layers.values():
            self._index_consumers(layer)

    def _index_consumers(self, layer: Layer) -> None:
        for dep in layer.feature_inputs():
            self._consumer_names.setdefault(dep, []).append(layer.name)

    def add(self, layer: Layer) -> Layer:
        if layer.name in self.layers:
            raise ValueError(f"duplicate layer {layer.name!r}")
        for dep in layer.feature_inputs():
            if dep not in (INPUT,) and dep not in self.layers:
                raise ValueError(f"{layer.name!r} depends on unknown {dep!r}")
        self.layers[layer.name] = layer
        self._index_consumers(layer)
        return layer

    def topo_order(self) -> list[Layer]:
        """Dependency-first (post-)order over insertion order, iterative so
        block stacks hundreds of layers deep stay clear of the Python
        recursion limit."""
        order: list[Layer] = []
        done: set[str] = set()
        for root in self.layers:
            if root in done:
                continue
            stack = [(root, iter(self.layers[root].feature_inputs()))]
            while stack:
                name, it = stack[-1]
                pushed = False
                for dep in it:
                    if dep == INPUT or dep in done:
                        continue
                    stack.append(
                        (dep, iter(self.layers[dep].feature_inputs())))
                    pushed = True
                    break
                if not pushed:
                    stack.pop()
                    if name not in done:
                        done.add(name)
                        order.append(self.layers[name])
        return order

    def consumers(self, name: str) -> list[Layer]:
        return [self.layers[c] for c in self._consumer_names.get(name, ())]

    def total_macs(self) -> int:
        return sum(l.macs() for l in self.layers.values())

    def total_vector_ops(self) -> int:
        return sum(l.vector_ops() for l in self.layers.values())

    @property
    def input_words(self) -> int:
        return self.input_rows * self.input_cols

    @property
    def n_blocks(self) -> int:
        """Number of network blocks (1 for single-block workloads)."""
        return max(self.block_of.values(), default=0) + 1

    def block_weight_words(self, block: int) -> int:
        """Constant-weight words of all layers in ``block`` — the
        traffic a core pays to (re)load that block's weights."""
        return sum(l.weight_words() for l in self.layers.values()
                   if self.block_of.get(l.name, 0) == block)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def attention_head(M: int, N: int, *, prefix: str = "",
                   materialize_transpose: bool = False) -> Workload:
    """The paper's single attention head (Fig. 1): input (M x N), weights
    W_Q/W_K/W_V (N x N); 7 layers.  1/sqrt(d_k) is folded into W_Q
    (paper Sec. II.A)."""
    p = prefix
    w = Workload(name=f"{p}attention_head_M{M}_N{N}",
                 input_rows=M, input_cols=N)
    w.add(MatMul(f"{p}Q", rows=M, cols=N, s=N, i1=INPUT, i2=WEIGHT))
    w.add(MatMul(f"{p}K", rows=M, cols=N, s=N, i1=INPUT, i2=WEIGHT))
    w.add(MatMul(f"{p}V", rows=M, cols=N, s=N, i1=INPUT, i2=WEIGHT))
    w.add(Transpose(f"{p}KT", rows=N, cols=M, src=f"{p}K",
                    materialize=materialize_transpose))
    w.add(MatMul(f"{p}QKT", rows=M, cols=M, s=N, i1=f"{p}Q", i2=f"{p}KT"))
    w.add(Softmax(f"{p}SM", rows=M, cols=M, src=f"{p}QKT"))
    w.add(MatMul(f"{p}AV", rows=M, cols=N, s=M, i1=f"{p}SM", i2=f"{p}V"))
    w.outputs = (f"{p}AV",)
    return w


def mhsa(M: int, d_model: int, n_heads: int, d_head: int, *,
         output_projection: bool = True) -> Workload:
    """Multi-head self attention: ``n_heads`` independent heads (the paper:
    'every attention layer consists of multiple previously-described heads
    in parallel') + optional output projection.

    Head h projects the (M x d_model) input with (d_model x d_head)
    weights; per-head attention matmuls use N=d_head.
    """
    w = Workload(name=f"mhsa_M{M}_D{d_model}_H{n_heads}x{d_head}",
                 input_rows=M, input_cols=d_model)
    head_outs = []
    for h in range(n_heads):
        p = f"h{h}."
        w.add(MatMul(f"{p}Q", rows=M, cols=d_head, s=d_model,
                     i1=INPUT, i2=WEIGHT))
        w.add(MatMul(f"{p}K", rows=M, cols=d_head, s=d_model,
                     i1=INPUT, i2=WEIGHT))
        w.add(MatMul(f"{p}V", rows=M, cols=d_head, s=d_model,
                     i1=INPUT, i2=WEIGHT))
        w.add(Transpose(f"{p}KT", rows=d_head, cols=M, src=f"{p}K"))
        w.add(MatMul(f"{p}QKT", rows=M, cols=M, s=d_head,
                     i1=f"{p}Q", i2=f"{p}KT"))
        w.add(Softmax(f"{p}SM", rows=M, cols=M, src=f"{p}QKT"))
        w.add(MatMul(f"{p}AV", rows=M, cols=d_head, s=M,
                     i1=f"{p}SM", i2=f"{p}V"))
        head_outs.append(f"{p}AV")
    if output_projection:
        # Concat of heads -> (M x n_heads*d_head) @ (n_heads*d_head x d_model).
        # Modelled as per-head partial projections accumulated elementwise;
        # for cost purposes a single matmul consuming every head output.
        prev = None
        for h, ho in enumerate(head_outs):
            name = f"proj{h}"
            w.add(MatMul(name, rows=M, cols=d_model, s=d_head,
                         i1=ho, i2=WEIGHT))
            if prev is not None:
                add = f"acc{h}"
                w.add(Elementwise(add, rows=M, cols=d_model,
                                  src=prev, src2=name))
                prev = add
            else:
                prev = name
        w.outputs = (prev,)
    else:
        w.outputs = tuple(head_outs)
    return w


def parallel_heads(M: int, N: int, n_heads: int) -> Workload:
    """Sec. IV.C.3 multi-core setting: ``n_heads`` independent M x N
    attention heads sharing the network input ('no inputs or weights are
    typically shared among heads' — each core executes another head).
    Outputs of every head stay live."""
    w = Workload(name=f"heads{n_heads}_M{M}_N{N}",
                 input_rows=M, input_cols=N)
    outs = []
    for h in range(n_heads):
        p = f"h{h}."
        w.add(MatMul(f"{p}Q", rows=M, cols=N, s=N, i1=INPUT, i2=WEIGHT))
        w.add(MatMul(f"{p}K", rows=M, cols=N, s=N, i1=INPUT, i2=WEIGHT))
        w.add(MatMul(f"{p}V", rows=M, cols=N, s=N, i1=INPUT, i2=WEIGHT))
        w.add(Transpose(f"{p}KT", rows=N, cols=M, src=f"{p}K"))
        w.add(MatMul(f"{p}QKT", rows=M, cols=M, s=N, i1=f"{p}Q",
                     i2=f"{p}KT"))
        w.add(Softmax(f"{p}SM", rows=M, cols=M, src=f"{p}QKT"))
        w.add(MatMul(f"{p}AV", rows=M, cols=N, s=M, i1=f"{p}SM",
                     i2=f"{p}V"))
        outs.append(f"{p}AV")
    w.outputs = tuple(outs)
    return w


def _add_gqa_attention(w: Workload, M: int, src: str, d_model: int,
                       n_heads: int, n_kv_heads: int, d_head: int,
                       prefix: str = "",
                       output_projection: bool = True) -> str:
    """Grouped-query attention reading features from ``src``: every query
    head projects its own Q; K/V (and the K^T view) are shared per KV
    group, so consecutive ``n_heads // n_kv_heads`` heads consume the
    same K^T / V feature tensors.  Returns the output layer name."""
    if n_heads % n_kv_heads:
        raise ValueError(f"n_heads={n_heads} not divisible by "
                         f"n_kv_heads={n_kv_heads}")
    p = prefix
    group = n_heads // n_kv_heads
    for g in range(n_kv_heads):
        w.add(MatMul(f"{p}kv{g}.K", rows=M, cols=d_head, s=d_model,
                     i1=src, i2=WEIGHT))
        w.add(Transpose(f"{p}kv{g}.KT", rows=d_head, cols=M,
                        src=f"{p}kv{g}.K"))
        w.add(MatMul(f"{p}kv{g}.V", rows=M, cols=d_head, s=d_model,
                     i1=src, i2=WEIGHT))
    head_outs = []
    for h in range(n_heads):
        g = h // group
        w.add(MatMul(f"{p}h{h}.Q", rows=M, cols=d_head, s=d_model,
                     i1=src, i2=WEIGHT))
        w.add(MatMul(f"{p}h{h}.QKT", rows=M, cols=M, s=d_head,
                     i1=f"{p}h{h}.Q", i2=f"{p}kv{g}.KT"))
        w.add(Softmax(f"{p}h{h}.SM", rows=M, cols=M, src=f"{p}h{h}.QKT"))
        w.add(MatMul(f"{p}h{h}.AV", rows=M, cols=d_head,
                     s=M, i1=f"{p}h{h}.SM", i2=f"{p}kv{g}.V"))
        head_outs.append(f"{p}h{h}.AV")
    if not output_projection:
        return head_outs[-1]
    # concat-of-heads projection modelled as per-head partial projections
    # accumulated elementwise (same convention as mhsa()).
    prev = None
    for h, ho in enumerate(head_outs):
        name = f"{p}proj{h}"
        w.add(MatMul(name, rows=M, cols=d_model, s=d_head,
                     i1=ho, i2=WEIGHT))
        if prev is None:
            prev = name
        else:
            w.add(Elementwise(f"{p}acc{h}", rows=M, cols=d_model,
                              src=prev, src2=name))
            prev = f"{p}acc{h}"
    return prev


def _add_kv_cached_attention(w: Workload, M: int, src: str, d_model: int,
                             n_heads: int, n_kv_heads: int, d_head: int,
                             n_ctx: int, prefix: str = "",
                             output_projection: bool = True) -> str:
    """Decode-phase grouped-query attention reading features from
    ``src``: M (= 1..few) new-token rows against an ``n_ctx``-deep
    persistent K/V cache.

    Per KV group the new token's K/V rows are projected and *written to
    the cache* (``cache_layers`` — they never occupy active feature
    memory); the score matmul reads the whole cached K^T as a KVCACHE
    operand (M x n_ctx scores), gated on the group's K append so the
    current token attends to itself; likewise (QK^T)V reads cached V
    gated on the V append.  ``n_ctx`` counts the *total* context
    including the M new rows.  Returns the output layer name and adds
    2 * n_ctx * d_head words per KV group to ``w.kv_cache_words``.
    """
    if n_heads % n_kv_heads:
        raise ValueError(f"n_heads={n_heads} not divisible by "
                         f"n_kv_heads={n_kv_heads}")
    p = prefix
    group = n_heads // n_kv_heads
    for g in range(n_kv_heads):
        w.add(MatMul(f"{p}kv{g}.K", rows=M, cols=d_head, s=d_model,
                     i1=src, i2=WEIGHT))
        w.add(MatMul(f"{p}kv{g}.V", rows=M, cols=d_head, s=d_model,
                     i1=src, i2=WEIGHT))
        w.cache_layers.update({f"{p}kv{g}.K", f"{p}kv{g}.V"})
        w.kv_cache_words += 2 * n_ctx * d_head
    head_outs = []
    for h in range(n_heads):
        g = h // group
        w.add(MatMul(f"{p}h{h}.Q", rows=M, cols=d_head, s=d_model,
                     i1=src, i2=WEIGHT))
        w.add(MatMul(f"{p}h{h}.QKT", rows=M, cols=n_ctx, s=d_head,
                     i1=f"{p}h{h}.Q", i2=KVCACHE,
                     gated_by=(f"{p}kv{g}.K",)))
        w.add(Softmax(f"{p}h{h}.SM", rows=M, cols=n_ctx,
                      src=f"{p}h{h}.QKT"))
        w.add(MatMul(f"{p}h{h}.AV", rows=M, cols=d_head, s=n_ctx,
                     i1=f"{p}h{h}.SM", i2=KVCACHE,
                     gated_by=(f"{p}kv{g}.V",)))
        head_outs.append(f"{p}h{h}.AV")
    if not output_projection:
        return head_outs[-1]
    prev = None
    for h, ho in enumerate(head_outs):
        name = f"{p}proj{h}"
        w.add(MatMul(name, rows=M, cols=d_model, s=d_head,
                     i1=ho, i2=WEIGHT))
        if prev is None:
            prev = name
        else:
            w.add(Elementwise(f"{p}acc{h}", rows=M, cols=d_model,
                              src=prev, src2=name))
            prev = f"{p}acc{h}"
    return prev


def kv_cached_attention(M: int, N_ctx: int, N: int, *,
                        prefix: str = "") -> Workload:
    """The decode-phase analogue of :func:`attention_head` (the paper's
    Fig. 1 head with K/V coming from an ``N_ctx``-deep cache).

    Args:
        M:     new query rows (1 for single-token decode).
        N_ctx: total context length the scores span (cache depth,
               including the M new rows).
        N:     head dimension.  Unlike the paper's square prefill head
               there is no N x N convention to infer it from, so it is
               required.

    Layers: Q / K / V projections of the (M x N) input (K and V are
    cache appends), the M x N_ctx score matmul against cached K^T,
    row-wise softmax, and (QK^T)V against cached V.  The cache
    footprint (2 * N_ctx * N words) is on ``kv_cache_words``, *not* in
    the active-feature peak.
    """
    if N <= 0:
        raise ValueError("kv_cached_attention needs the head dim N > 0")
    if N_ctx < M:
        raise ValueError(f"N_ctx counts the total context including "
                         f"the new rows: need N_ctx >= M, got "
                         f"N_ctx={N_ctx} M={M}")
    p = prefix
    w = Workload(name=f"{p}kv_attention_M{M}_C{N_ctx}_N{N}",
                 input_rows=M, input_cols=N)
    w.add(MatMul(f"{p}Q", rows=M, cols=N, s=N, i1=INPUT, i2=WEIGHT))
    w.add(MatMul(f"{p}K", rows=M, cols=N, s=N, i1=INPUT, i2=WEIGHT))
    w.add(MatMul(f"{p}V", rows=M, cols=N, s=N, i1=INPUT, i2=WEIGHT))
    w.cache_layers.update({f"{p}K", f"{p}V"})
    w.kv_cache_words += 2 * N_ctx * N
    w.add(MatMul(f"{p}QKT", rows=M, cols=N_ctx, s=N, i1=f"{p}Q",
                 i2=KVCACHE, gated_by=(f"{p}K",)))
    w.add(Softmax(f"{p}SM", rows=M, cols=N_ctx, src=f"{p}QKT"))
    w.add(MatMul(f"{p}AV", rows=M, cols=N, s=N_ctx, i1=f"{p}SM",
                 i2=KVCACHE, gated_by=(f"{p}V",)))
    w.outputs = (f"{p}AV",)
    return w


def _add_ffn(w: Workload, M: int, src: str, d_model: int, d_ff: int,
             kind: str = "silu_glu", prefix: str = "") -> str:
    """Feed-forward network reading features from ``src``.

    ``silu_glu``: gate/up projections, SiLU on the gate, elementwise
    product, down projection (the GLU family used by qwen3 / deepseek /
    starcoder2's variants).  ``gelu``: classic dense up -> GELU -> down.
    Returns the output layer name.
    """
    p = prefix
    if kind == "silu_glu":
        w.add(MatMul(f"{p}gate", rows=M, cols=d_ff, s=d_model,
                     i1=src, i2=WEIGHT))
        w.add(MatMul(f"{p}up", rows=M, cols=d_ff, s=d_model,
                     i1=src, i2=WEIGHT))
        w.add(Elementwise(f"{p}act", rows=M, cols=d_ff, src=f"{p}gate"))
        w.add(Elementwise(f"{p}mul", rows=M, cols=d_ff, src=f"{p}act",
                          src2=f"{p}up"))
        hidden = f"{p}mul"
    elif kind == "gelu":
        w.add(MatMul(f"{p}up", rows=M, cols=d_ff, s=d_model,
                     i1=src, i2=WEIGHT))
        w.add(Elementwise(f"{p}act", rows=M, cols=d_ff, src=f"{p}up"))
        hidden = f"{p}act"
    else:
        raise ValueError(f"unknown ffn kind {kind!r}")
    w.add(MatMul(f"{p}down", rows=M, cols=d_model, s=d_ff,
                 i1=hidden, i2=WEIGHT))
    return f"{p}down"


def ffn(M: int, d_model: int, d_ff: int, *, kind: str = "silu_glu",
        prefix: str = "") -> Workload:
    """Standalone FFN workload: (M x d_model) features through a dense
    (``gelu``) or GLU (``silu_glu``) feed-forward of hidden width d_ff."""
    w = Workload(name=f"{prefix}ffn_{kind}_M{M}_D{d_model}_F{d_ff}",
                 input_rows=M, input_cols=d_model)
    out = _add_ffn(w, M, INPUT, d_model, d_ff, kind, prefix)
    w.outputs = (out,)
    return w


def gqa_attention(M: int, d_model: int, n_heads: int, *,
                  n_kv_heads: int = 0, d_head: int = 0,
                  prefix: str = "") -> Workload:
    """Standalone grouped-query attention workload (n_kv_heads=0 or
    == n_heads degenerates to classic MHSA)."""
    n_kv_heads = n_kv_heads or n_heads
    d_head = d_head or d_model // n_heads
    w = Workload(
        name=f"{prefix}gqa_M{M}_D{d_model}_H{n_heads}kv{n_kv_heads}",
        input_rows=M, input_cols=d_model)
    out = _add_gqa_attention(w, M, INPUT, d_model, n_heads, n_kv_heads,
                             d_head, prefix)
    w.outputs = (out,)
    return w


def _add_transformer_block(w: Workload, M: int, src: str, d_model: int,
                           n_heads: int, d_ff: int, *,
                           n_kv_heads: int, d_head: int,
                           mlp: str = "silu_glu", norm: str = "pre",
                           phase: str = "prefill", n_ctx: int = 0,
                           prefix: str = "") -> str:
    """One transformer block reading features from ``src`` (INPUT or a
    previous block's output).  ``phase="decode"`` swaps the attention
    for the KV-cached decode variant spanning ``n_ctx`` context rows.
    Returns the block output layer name."""
    p = prefix
    if phase == "prefill":
        def attn_of(s):
            return _add_gqa_attention(w, M, s, d_model, n_heads,
                                      n_kv_heads, d_head, p)
    elif phase == "decode":
        if n_ctx < M:
            raise ValueError(f"decode phase needs n_ctx >= M, got "
                             f"n_ctx={n_ctx} M={M}")

        def attn_of(s):
            return _add_kv_cached_attention(w, M, s, d_model, n_heads,
                                            n_kv_heads, d_head, n_ctx, p)
    else:
        raise ValueError(f"unknown phase {phase!r}; expected one of "
                         f"{PHASES}")
    if norm == "pre":
        w.add(LayerNorm(f"{p}ln1", rows=M, cols=d_model, src=src))
        attn = attn_of(f"{p}ln1")
        w.add(Elementwise(f"{p}res1", rows=M, cols=d_model,
                          src=attn, src2=src))
        w.add(LayerNorm(f"{p}ln2", rows=M, cols=d_model, src=f"{p}res1"))
        out = _add_ffn(w, M, f"{p}ln2", d_model, d_ff, mlp, p)
        w.add(Elementwise(f"{p}res2", rows=M, cols=d_model,
                          src=out, src2=f"{p}res1"))
        return f"{p}res2"
    elif norm == "post":
        attn = attn_of(src)
        w.add(Elementwise(f"{p}res1", rows=M, cols=d_model,
                          src=attn, src2=src))
        w.add(LayerNorm(f"{p}ln1", rows=M, cols=d_model, src=f"{p}res1"))
        out = _add_ffn(w, M, f"{p}ln1", d_model, d_ff, mlp, p)
        w.add(Elementwise(f"{p}res2", rows=M, cols=d_model,
                          src=out, src2=f"{p}ln1"))
        w.add(LayerNorm(f"{p}ln2", rows=M, cols=d_model, src=f"{p}res2"))
        return f"{p}ln2"
    raise ValueError(f"unknown norm placement {norm!r}")


def transformer_block(M: int, d_model: int, n_heads: int, d_ff: int, *,
                      n_kv_heads: int = 0, d_head: int = 0,
                      mlp: str = "silu_glu", norm: str = "pre",
                      phase: str = "prefill", n_ctx: int = 0,
                      prefix: str = "") -> Workload:
    """One full transformer block: norm + GQA attention + residual add +
    norm + FFN + residual add.

    ``norm="pre"`` (qwen3/starcoder2/...): x + Attn(LN(x)), then
    y + FFN(LN(y)); the block output is the second residual sum.
    ``norm="post"``: LN(x + Attn(x)), LN(y + FFN(y)) (original
    encoder convention, e.g. hubert's transformer trunk).

    ``phase="decode"`` builds the KV-cached decode variant: M is the
    new-token count (usually 1) and ``n_ctx`` the total context depth
    the cached attention spans.
    """
    n_kv_heads = n_kv_heads or n_heads
    d_head = d_head or d_model // n_heads
    p = prefix
    tag = f"_C{n_ctx}" if phase == "decode" else ""
    w = Workload(
        name=f"{p}block_M{M}_D{d_model}_H{n_heads}kv{n_kv_heads}"
             f"_F{d_ff}{tag}",
        input_rows=M, input_cols=d_model)
    out = _add_transformer_block(w, M, INPUT, d_model, n_heads, d_ff,
                                 n_kv_heads=n_kv_heads, d_head=d_head,
                                 mlp=mlp, norm=norm, phase=phase,
                                 n_ctx=n_ctx, prefix=p)
    w.outputs = (out,)
    return w


def _config_dims(cfg, layer_index: int = 0) -> dict:
    """Duck-typed dims of one attention block of a ModelConfig-like
    object (so the core stays importable without JAX).  MoE layers are
    modelled as the dense-equivalent routed compute (top_k * d_expert
    hidden width — the per-token FLOPs actually executed).  Attention
    flavours beyond GQA/MHA (MLA, SSM/mamba blocks) are not
    expressible yet and raise ``ValueError``."""
    kind = cfg.block_kind(layer_index) if hasattr(cfg, "block_kind") \
        else "attn"
    if kind != "attn":
        raise ValueError(
            f"{cfg.name}: layer {layer_index} is a {kind!r} block; only "
            "attention blocks are expressible as DSE workloads")
    attention = getattr(cfg, "attention", "gqa")
    if attention not in ("gqa",):
        raise ValueError(
            f"{cfg.name}: attention flavour {attention!r} is not "
            "expressible yet (GQA/MHA only)")
    d_ff = cfg.d_ff
    if hasattr(cfg, "ffn_kind") and cfg.ffn_kind(layer_index) == "moe":
        d_ff = (getattr(cfg, "d_expert", 0) or cfg.d_ff) \
            * max(getattr(cfg, "top_k", 1), 1)
    n_heads = cfg.n_heads
    return {
        "d_model": cfg.d_model, "n_heads": n_heads, "d_ff": d_ff,
        "n_kv_heads": getattr(cfg, "kv_heads", 0) or n_heads,
        "d_head": getattr(cfg, "head_dim", 0) or cfg.d_model // n_heads,
        "mlp": getattr(cfg, "mlp", "silu_glu"),
    }


def from_model_config(cfg, seq_len: int, *, layer_index: int = 0,
                      norm: str = "pre", phase: str = "prefill",
                      n_ctx: int = 0) -> Workload:
    """Bridge a ``models.common.ModelConfig`` (anything in
    ``repro_torch.configs.ARCHS``) to a one-block DSE workload.

    Args:
        cfg:         a ModelConfig or any object with d_model /
                     n_heads / kv_heads / head_dim / d_ff (/ mlp) —
                     duck-typed so the core stays importable without
                     JAX.
        seq_len:     query rows M.  For ``phase="prefill"`` this is
                     the prompt length; for ``phase="decode"`` the
                     new-token count (usually 1).
        layer_index: which block of a hybrid/MoE stack to model (MoE
                     hidden width is the dense-equivalent routed
                     compute; MLA/SSM blocks raise ``ValueError``).
        phase:       "prefill" (self-attention over seq_len) or
                     "decode" (KV-cached attention over ``n_ctx``).
        n_ctx:       total context depth for the decode phase.

    Returns a one-block :class:`Workload` ready for
    ``scheduler.evaluate`` / ``fusion.explore``.

    >>> from types import SimpleNamespace
    >>> cfg = SimpleNamespace(name="toy", d_model=64, n_heads=2,
    ...                       kv_heads=1, head_dim=32, d_ff=128)
    >>> blk = from_model_config(cfg, 16)
    >>> blk.name
    'toy_L0_M16'
    >>> dec = from_model_config(cfg, 1, phase="decode", n_ctx=256)
    >>> dec.kv_cache_words == 2 * 256 * 32   # one KV group's K + V
    True
    """
    dims = _config_dims(cfg, layer_index)
    w = transformer_block(
        seq_len, dims["d_model"], dims["n_heads"], dims["d_ff"],
        n_kv_heads=dims["n_kv_heads"], d_head=dims["d_head"],
        mlp=dims["mlp"], norm=norm, phase=phase, n_ctx=n_ctx)
    tag = f"_C{n_ctx}" if phase == "decode" else ""
    w.name = f"{cfg.name}_L{layer_index}_M{seq_len}{tag}"
    return w


def network(cfg, n_blocks: int, *, phase: str = "prefill",
            seq_len: int = 0, n_ctx: int = 0, norm: str = "pre",
            layer_index: int = 0) -> Workload:
    """Stitch ``n_blocks`` repeated transformer blocks of ``cfg`` into
    one whole-network workload with residual carry-over.

    Block ``i``'s layers carry prefix ``b{i}.`` and read the previous
    block's output; ``block_of`` maps every layer to its block index so
    the engine can charge weight-reload traffic when a core switches
    blocks, and ``period_prefixes`` marks the blocks as structurally
    identical so ``spacegen.generate`` explores one block's sub-space
    and replicates it (block-periodic symmetry).

    Args:
        cfg:      ModelConfig-like object (see
                  :func:`from_model_config`).
        n_blocks: how many identical blocks to stitch (use
                  ``cfg.n_layers`` for the full network).
        phase:    "prefill" (M = seq_len self-attention) or "decode"
                  (M = seq_len new tokens — usually 1 — against an
                  ``n_ctx``-deep KV cache *per block*).
        seq_len:  query rows M (required; decode default 1).
        n_ctx:    context depth for decode.

    Returns a :class:`Workload` whose ``kv_cache_words`` accumulates
    every block's cache footprint and whose single output is the last
    block's residual sum.
    """
    if n_blocks < 1:
        raise ValueError("network needs n_blocks >= 1")
    if seq_len <= 0:
        seq_len = 1 if phase == "decode" else 0
    if seq_len <= 0:
        raise ValueError("network(prefill) needs seq_len > 0")
    dims = _config_dims(cfg, layer_index)
    tag = f"_C{n_ctx}" if phase == "decode" else ""
    w = Workload(name=f"{cfg.name}_net{n_blocks}x_{phase}"
                      f"_M{seq_len}{tag}",
                 input_rows=seq_len, input_cols=dims["d_model"])
    src = INPUT
    prefixes = []
    for b in range(n_blocks):
        p = f"b{b}."
        n_before = len(w.layers)
        src = _add_transformer_block(
            w, seq_len, src, dims["d_model"], dims["n_heads"],
            dims["d_ff"], n_kv_heads=dims["n_kv_heads"],
            d_head=dims["d_head"], mlp=dims["mlp"], norm=norm,
            phase=phase, n_ctx=n_ctx, prefix=p)
        # dicts iterate in insertion order: the block's layers are
        # exactly the suffix added since n_before
        added = len(w.layers) - n_before
        for name in itertools.islice(reversed(w.layers), added):
            w.block_of[name] = b
        prefixes.append(p)
    w.outputs = (src,)
    w.period_prefixes = tuple(prefixes)
    return w


def cct_mhsa(seq_len: int, *, n_heads: int = 8, d_model: int = 32,
             d_head: int = 32) -> Workload:
    """The Sec. III validation network: CCT-like MHSA, 32 embedding
    channels, projection space 32, deployed at seq 81 and 128 on GAP8
    (I-BERT integer ops; requant folded into utilization calibration).

    MAC count = n_heads*(3*M*d_model*d_head + 2*M^2*d_head)
                + M*(n_heads*d_head)*d_model
    which for (81, 8, 32, 32) is ~6.01 MMAC -> measured 1.836 MCycles is
    the paper's 'average of 3.2 MAC/cycle'.
    """
    return mhsa(seq_len, d_model=d_model, n_heads=n_heads, d_head=d_head)
