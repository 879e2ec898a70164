"""Space-filling curves for sort-compaction (port of
paimon_tpu/ops/zorder.py: z_order_lanes, hilbert_lanes).

Inputs are the order-preserving uint32 key lanes of data/keys.py; outputs
are uint32 lane matrices whose lexicographic order is the curve's order,
ready for the same merge sort as any key (table/sort_compact.py). Both
transforms are 32*K vector passes of numpy bit operations over whole
columns on the host, as in the JAX package (no device program there), and
their lanes equal the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["z_order_lanes", "hilbert_lanes"]


def z_order_lanes(lanes: np.ndarray) -> np.ndarray:
    """(n, K) uint32 -> (n, K) uint32 whose lex order equals Z-curve order
    (bit-interleave: msb of col0, msb of col1, ..., next bit of col0, ...)."""
    n, k = lanes.shape
    if k <= 1:
        return lanes.copy()
    out = np.zeros((n, k), dtype=np.uint32)
    for b in range(31, -1, -1):  # source bit, msb first
        for c in range(k):
            bit = (lanes[:, c] >> np.uint32(b)) & np.uint32(1)
            p = (31 - b) * k + c  # global position from the msb
            out_lane = p // 32
            out_bit = 31 - (p % 32)
            out[:, out_lane] |= bit << np.uint32(out_bit)
    return out


def hilbert_lanes(lanes: np.ndarray, bits: int = 32) -> np.ndarray:
    """(n, K) uint32 -> (n, K) uint32 in Hilbert-curve order (Skilling's
    transform, vectorized across rows)."""
    n, k = lanes.shape
    if k <= 1:
        return lanes.copy()
    x = lanes.astype(np.uint32).T.copy()  # (K, n)
    m = np.uint32(1) << np.uint32(bits - 1)
    # inverse undo excess work (Skilling 2004, transposed form)
    q = m
    while q > 1:
        p = np.uint32(q - 1)
        for i in range(k):
            swap = (x[i] & q) != 0
            # invert or exchange low bits
            x[0] = np.where(swap, x[0] ^ p, x[0])
            t = (x[0] ^ x[i]) & p
            t = np.where(swap, np.uint32(0), t)
            x[0] ^= t
            x[i] ^= t
        q >>= np.uint32(1)
    # gray encode
    for i in range(1, k):
        x[i] ^= x[i - 1]
    t = np.zeros(n, dtype=np.uint32)
    q = m
    while q > 1:
        t = np.where((x[k - 1] & q) != 0, t ^ np.uint32(q - 1), t)
        q >>= np.uint32(1)
    for i in range(k):
        x[i] ^= t
    # x now holds the transposed hilbert index: bit-interleave to compare
    return z_order_lanes(x.T)
