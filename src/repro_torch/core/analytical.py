"""Closed-form active-feature-memory expressions of the paper (Sec.
IV.B.2 and IV.C, Eqs. 3-9) that the serving plan's decision rule reads;
a copy of ``repro/core/analytical.py:29-40,61-91``.

All quantities are in words for one attention head with input M x N.
"""

from __future__ import annotations


def alpha(M: int, N: int) -> float:
    """Relative memory footprint gain alpha = A_LF / A_LBL (Fig. 6):
    (2N + M) / 3N for M < N (Eq. 3), 1 for M = N (Eq. 6), 3N / (2N + M)
    for M > N (Eq. 7)."""
    if M < N:
        return (2 * N + M) / (3 * N)
    if M == N:
        return 1.0
    return (3 * N) / (2 * N + M)


def a_lbl_kv(M: int, C: int, N: int) -> int:
    """Peak active-feature memory of the layer-by-layer KV-cached head,
    M * max(2N, C): cached K/V never occupy active memory, so the peak
    is input + Q or the materialised M x C score matrix."""
    return M * max(2 * N, C)


def a_lf_kv(M: int, C: int, N: int) -> int:
    """Peak active-feature memory of the layer-fused KV-cached head: the
    score matrix never materialises, so the peak is input + Q = 2MN."""
    return 2 * M * N


def alpha_kv(M: int, C: int, N: int) -> float:
    """Decode-phase gain A_LF / A_LBL = min(1, 2N / C): the crossover
    moves from M = N to C = 2N once the cache holds K/V."""
    return a_lf_kv(M, C, N) / a_lbl_kv(M, C, N)
