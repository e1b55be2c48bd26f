"""Shared model pieces of the port: the config, the device rule, norms,
RoPE, the MLP and the cross entropy.

``ModelConfig`` is the JAX package's (``repro/models/common.py``), field
for field, so one config object describes the same model to both; it
returns torch dtypes (:meth:`ModelConfig.torch_dtype`) where the JAX one
returns jnp dtypes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.collectives import pmax, psum, to_stream
from repro_torch.sharding.rules import active_mesh, splits


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX package's ModelConfig, field for field (the port runs its
    GQA members, dense or MoE, and its pure Mamba-2 ones so far)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: int = 0                 # 0 -> = n_heads
    d_head: int = 0                     # 0 -> d_model // n_heads
    # attention flavour
    attention: str = "gqa"              # gqa | mla | none
    qk_norm: bool = False
    causal: bool = True                 # False: encoder-only (hubert)
    rope_theta: float = 1e6
    # MLA (deepseek-v3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0
    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 2
    d_expert: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0         # deepseek: dense FFN prefix
    moe_every: int = 1                  # jamba: MoE every 2nd layer
    # SSM / hybrid
    attn_every: int = 1                 # 1: all-attn; 0: none; 8: jamba
    attn_offset: int = 3                # position of attn layer in period
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    d_inner: int = 0                    # 0 -> 2 * d_model
    # modality frontend
    frontend: str = "none"              # none | vision_stub | audio_stub
    frontend_dim: int = 0
    # MLP flavour
    mlp: str = "silu_glu"               # silu_glu | gelu
    tie_embeddings: bool = False
    # multi-device paths, inert without an active mesh
    # (sharding.set_rules_for_mesh)
    distributed_decode: bool = False
    head_parallel_decode: bool = False
    moe_local_dispatch: bool = False
    moe_shard_map_ep: bool = False
    moe_expert_major_dispatch: bool = False
    moe_group_size: int = 0
    # numerics / compilation
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"                 # none | full | dots
    scan_layers: bool = True
    attn_impl: str = "auto"
    attn_block_q: Optional[int] = None
    attn_block_k: Optional[int] = None
    ssd_chunk: int = 128
    max_seq_len: int = 524288

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def inner_dim(self) -> int:
        return self.d_inner or 2 * self.d_model

    def torch_dtype(self, which: str = "compute") -> torch.dtype:
        """The compute (``"compute"``) or parameter (``"param"``) dtype
        as a torch dtype."""
        name = self.compute_dtype if which == "compute" else self.param_dtype
        return getattr(torch, name)

    # ---- layer pattern (hybrid archs) -------------------------------
    def block_kind(self, i: int) -> str:
        if self.attn_every == 0:
            return "mamba"
        if self.attn_every == 1:
            return "attn"
        return "attn" if i % self.attn_every == self.attn_offset else "mamba"

    def ffn_kind(self, i: int) -> str:
        if not self.moe or i < self.first_dense_layers:
            return "dense"
        return "moe" if (i - self.first_dense_layers) % self.moe_every \
            == self.moe_every - 1 or self.moe_every == 1 else "dense"

    @property
    def layer_period(self) -> int:
        p = 1
        if self.attn_every > 1:
            p = self.attn_every
        if self.moe and self.moe_every > 1:
            p = p * self.moe_every // math.gcd(p, self.moe_every)
        return p

    @property
    def n_periods(self) -> int:
        body = self.n_layers - self.first_dense_layers
        if body % self.layer_period:
            raise ValueError(f"{self.name}: {body} layers not divisible "
                             f"by period {self.layer_period}")
        return body // self.layer_period


def resolve_device(device="cuda") -> torch.device:
    """The port's device rule: entry points default to the card and
    raise when there is none; the CPU runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Primitives (repro/models/common.py:206-244)
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6, *, mesh=None,
             width: Optional[int] = None) -> torch.Tensor:
    """RMSNorm over the last dim.  ``mesh``: ``x`` (and ``weight``)
    hold this rank's block of that dim over "model", ``width`` wide in
    whole, and the sum of squares is summed over "model" first, as the
    whole norm takes it."""
    xf = x.float()
    if mesh is None:
        ms = xf.pow(2).mean(-1, keepdim=True)
    else:
        ms = psum(xf.pow(2).sum(-1, keepdim=True), mesh, "model") / width
    out = xf * torch.rsqrt(ms + eps)
    return (out * weight.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, half-split pairs rotated in fp32.  x: (..., S,
    D); positions: (..., S) with head axes inserted between batch and
    sequence to match x's rank."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions.float()[..., None] * freqs
    while ang.ndim < x.ndim:
        ang = ang.unsqueeze(-3)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def mlp_forward(params: dict, x: torch.Tensor, kind: str,
                specs: Optional[dict] = None,
                seq: bool = False) -> torch.Tensor:
    """Gated-SiLU or GELU MLP.  jax.nn.gelu defaults to the tanh
    approximation, so the GELU here is the tanh form too.  ``specs``
    (the sharded serving state, or the tensor-parallel training
    layout): the leaves' specs; where they make the hidden width this
    rank's block over "model" (``w_up``/``w_gate`` column blocks,
    ``w_down`` a row block), the local product is a partial that one
    ``psum`` over "model" sums, the partition GSPMD makes of JAX's
    ``constrain(h, ..., "mlp")`` (its backward the ``psum`` of the
    ranks' shares of the output's cotangent).  ``seq``
    (``seq_stream``): the output is this rank's sequence block, the
    partials reduce-scattered, a whole output sliced
    (``collectives.to_stream``)."""
    dt = x.dtype
    if kind == "silu_glu":
        g = x @ params["w_gate"].to(dt)
        u = x @ params["w_up"].to(dt)
        h = F.silu(g.float()).to(dt) * u
    else:
        h = x @ params["w_up"].to(dt)
        h = F.gelu(h.float(), approximate="tanh").to(dt)
    out = h @ params["w_down"].to(dt)
    mesh = active_mesh()
    return to_stream(out, mesh, seq=seq, partial=specs is not None
                     and splits(specs["w_down"], 0, mesh))


def token_nll(logits: torch.Tensor, targets: torch.Tensor,
              mesh=None) -> torch.Tensor:
    """Each token's negative log-likelihood, the logits in fp32.
    ``mesh``: ``logits`` are this rank's block of vocabulary columns
    over "model" (JAX's ``constrain(logits, "batch", "seq", "vocab")``),
    and the loss is taken on them without gathering the rows: the row
    max is the ranks' ``pmax`` (no gradient flows through it), the
    exponential sums are summed (``psum``), and the target's logit
    comes from the rank whose columns hold it (``psum`` of its column
    and the others' zeros)."""
    logits = logits.float()
    if mesh is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        return lse - ll
    cols = logits.shape[-1]
    top = pmax(logits.detach().amax(-1), mesh, "model")
    total = psum(torch.exp(logits - top[..., None]).sum(-1), mesh, "model")
    local = targets.long() - mesh.axis_index("model") * cols
    own = (local >= 0) & (local < cols)
    picked = torch.gather(logits, -1, local.clamp(0, cols - 1)[..., None])
    ll = psum(torch.where(own, picked[..., 0], 0.0), mesh, "model")
    return torch.log(total) + top - ll


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy with the logits in fp32
    (``repro/models/common.py:256-266``); with ``mask``, the mean over
    the masked-in tokens (at least 1)."""
    nll = token_nll(logits, targets)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
