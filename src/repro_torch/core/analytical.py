"""Closed-form active-feature-memory expressions from the paper
(Sec. IV.B.2 and IV.C, Eqs. 3-9) — the oracle the DSE engine is
validated against.

All quantities are in words for a single attention head with input
M x N and N x N weight matrices.

A copy of the JAX package's ``repro/core/analytical.py`` with its names and
arithmetic unchanged, so that the port's results are bit-equal to
the reference's; the port imports nothing of that package.
"""

from __future__ import annotations


def a_lbl(M: int, N: int) -> int:
    """Peak active-feature memory of the memory-optimal layer-by-layer
    schedule (Sec. IV.B.2):  3MN if M <= N else 2MN + M^2."""
    if M <= N:
        return 3 * M * N
    return 2 * M * N + M * M


def a_lf(M: int, N: int) -> int:
    """Peak active-feature memory of the memory-optimal layer-fused
    schedule (Sec. IV.C):  2MN + M^2 for M < N (fuse Q -> QK^T),
    3MN for M >= N (fuse QK^T -> softmax -> .V)."""
    if M < N:
        return 2 * M * N + M * M
    return 3 * M * N


def alpha(M: int, N: int) -> float:
    """Relative memory footprint gain alpha = A_LF / A_LBL (Fig. 6).

    Eq. 3:  (2N + M) / 3N        for M < N
    Eq. 6:  1                    for M = N
    Eq. 7:  3N / (2N + M)        for M > N
    """
    if M < N:
        return (2 * N + M) / (3 * N)
    if M == N:
        return 1.0
    return (3 * N) / (2 * N + M)


def alpha_limit_flat() -> float:
    """Eq. 4: lim_{M/N -> 0} alpha = 2/3 (memory reduced by one third)."""
    return 2.0 / 3.0


def alpha_limit_deep(M: int, N: int) -> float:
    """Eq. 8: for M >> N, alpha ~= 3N/M (memory reduced to a third of
    M/N... i.e. to ~3N/M of the LBL footprint)."""
    return 3.0 * N / M


# ---------------------------------------------------------------------------
# Decode-phase (KV-cached) closed forms — the paper's Sec. IV analysis
# redone for the regime its conclusion targets: M = 1..few new query
# rows against an N_ctx-deep persistent K/V cache.  Cached K/V are not
# active feature data, which moves the fusion crossover.
# ---------------------------------------------------------------------------

def a_lbl_kv(M: int, C: int, N: int) -> int:
    """Peak active-feature memory (words) of the memory-optimal
    layer-by-layer KV-cached head:  M * max(2N, C).

    Args: M = new query rows, C = total context (score columns),
    N = head dim.  Derivation: cached K/V never occupy active memory,
    so the peak is either input + Q (2MN, live while the projections
    drain the input) or the fully materialised M x C score matrix
    (row substitution makes softmax memory-neutral)."""
    return M * max(2 * N, C)


def a_lf_kv(M: int, C: int, N: int) -> int:
    """Peak active-feature memory (words) of the layer-fused KV-cached
    head (QK^T -> softmax -> .V streamed, the Fig. 5c schedule applied
    to the cached score pipeline): the M x C score matrix never
    materialises and the peak is input + Q = 2MN, independent of the
    context depth."""
    return 2 * M * N


def alpha_kv(M: int, C: int, N: int) -> float:
    """Decode-phase relative memory gain  alpha = A_LF / A_LBL
    = min(1, 2N / C).

    The prefill crossover sits at M = N (Eq. 6); with the cache
    holding K/V the crossover moves to C = 2N — beyond two head-dims
    of context, score fusion always wins, and the gain grows linearly
    in context depth (alpha -> 2N/C), which is why the decode phase is
    where layer fusion matters most."""
    return a_lf_kv(M, C, N) / a_lbl_kv(M, C, N)


def attention_head_macs(M: int, N: int) -> int:
    """5 matmuls of the head: 3 projections (M.N.N) + QK^T (M.M.N) +
    (QK^T)V (M.M.N)."""
    return 3 * M * N * N + 2 * M * M * N


def mhsa_macs(M: int, d_model: int, n_heads: int, d_head: int,
              output_projection: bool = True) -> int:
    m = n_heads * (3 * M * d_model * d_head + 2 * M * M * d_head)
    if output_projection:
        m += M * (n_heads * d_head) * d_model
    return m
