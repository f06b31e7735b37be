"""The batched MSM's exceptional inputs (``ops.msm.msm_batched_affine``, K2b),
as the tests and the on-card smoke check build them: points base_i G1 with
known base_i, scalars as 256-bit ints (any, not only below r), and the
oracle (sum_i base_i k_i) G1."""

from __future__ import annotations

import torch

from ..ops.field import FP, FR
from . import hostmath as hm


def edge_lanes(x, y, base: list, ks: list):
    """Set the exceptional lanes in place on the affine words x, y (12, n) of
    the points base_i G1 and on the scalars ks, and return an (n,) inf_mask
    on x's device. n >= 10: lane 0 scalar 0, 1 scalar 1, 2 r - 1, 3 2^256 -
    1 (bit 255 set), lanes 4 and 5 P and -P with one scalar (their products
    cancel at the tree's first level), 6 and 7 one point and one scalar
    2^255 + k (the tree's add doubles), 8 the scalar r + 2 (the ladder meets
    acc == P at its last step: the exact madd doubles), 9 the scalar r (acc
    == -P: the madd gives infinity); the mask flags lanes 3 and n - 1.
    n = 3: lanes 0 and 1 one point and one scalar, lane 2 the scalar 0.
    n = 2: P and -P with one scalar. n = 1: the scalar r + 2. Below 10 lanes
    the mask flags nothing."""
    n = len(ks)
    mask = torch.zeros(n, dtype=torch.bool, device=x.device)

    def copy(dst, src, negate=False):
        x[:, dst] = x[:, src]
        y[:, dst] = FP.neg(y[:, src:src + 1])[:, 0] if negate else y[:, src]
        base[dst] = hm.R - base[src] if negate else base[src]
        ks[dst] = ks[src]

    if n >= 10:
        copy(5, 4, negate=True)
        ks[6] += 1 << 255
        copy(7, 6)
        ks[:4] = [0, 1, hm.R - 1, (1 << 256) - 1]
        ks[8:10] = [hm.R + 2, hm.R]
        mask[3] = mask[n - 1] = True
    elif n == 3:
        copy(1, 0)
        ks[2] = 0
    elif n == 2:
        copy(1, 0, negate=True)
    else:
        ks[0] = hm.R + 2
    return mask


def scalar_words(ks, device) -> torch.Tensor:
    """256-bit ints -> (8, n) int32 words, least significant first."""
    return torch.tensor([[(k >> (32 * w)) & 0xFFFFFFFF for k in ks] for w in range(FR.L)],
                        dtype=torch.int64).to(torch.int32).to(device)


def oracle(base: list, ks: list, mask=None) -> list:
    """[(sum_i base_i k_i) G1] over the lanes not flagged in mask, as an
    affine point (None for infinity)."""
    flags = [False] * len(ks) if mask is None else mask.tolist()
    k = sum(b * s for b, s, m in zip(base, ks, flags) if not m) % hm.R
    return [hm.g1_mul(hm.G1_GEN, k) if k else None]
