"""The bucket reduction's exceptional inputs (``ops.msm.bucket_reduce``), as
the tests and the on-card smoke check build them: sparse bucket sums
S_b = k_b G1 with a known weighted sum, checked against the host oracle."""

from __future__ import annotations

import torch

from ..ops.msm import BR_LEAVES
from . import hostmath as hm

TOP = 1 << 15
# b = 3234 and 3250 (in the JAX package's digit grid, elements 2 and 18 of
# the T1 sum (3, 5)) and b = 233 and 16617 (elements 0 and 16 of the T2 sum
# (7, 9)): in the one tree their leaves are equal runs, summed by doubling
T1, T2 = 3 * 1024 + 5 * 32 + 2, 7 * 32 + 9
# {b: k_b}, S_b = k_b G1. The sum is sum_(b < TOP) L_b with L_b = V_top -
# V_b, V_b the prefix sum through b: empty buckets make runs of equal
# leaves, so the tree's adds double and meet infinity throughout. Every
# oracle holds for any route.
BUCKET_CASES = {
    "every bucket empty": {},
    "only S_top": {TOP: 12345},  # every leaf V_top: doubles at every level
    "only b = 0": {0: 777},  # weight 0: every leaf infinity
    "only b = 2^15 - 1": {TOP - 1: 31},
    "equal sums in a tree": {T1: 11, T1 + 16: 11, T2: 4, T2 + 16 * 1024: 4},  # doubles
    "P and -P in a tree": {T1: 6, T1 + 16: -6},
    # L_0..L_99 = -3 G meet L_128..L_227 = 3 G at the first block-tree level
    # (s = 128): infinity
    "P and -P at a block-tree level": {100: -6, TOP: 3},
    # V_top infinity, leaves -5 G through block 1 and 5 G through block 65:
    # the two block sums meet at the last tree's first level (s = 64), the
    # block 2 run keeps the result finite
    "P and -P in the last tree": {BR_LEAVES: 5, 2 * BR_LEAVES: -5, 65 * BR_LEAVES: -5,
                                  66 * BR_LEAVES: 5, 600: 3, 700: -3},
}


def bucket_case(buckets: dict, device="cpu", valid: bool = True):
    """Inputs (U, off, slot, c, valid) of the bucket reduction whose bucket
    sums are k_b G1 for {b: k_b}, the other buckets infinity: U[b] = V_b -
    off[b % 2], V_b the host's prefix sum through b, off[0] infinity and
    off[1] 5 G1 (so that V_b goes through the add). valid=False marks every
    bucket invalid."""
    from ..ops import curve as cv
    from ..ops import scans

    offs = [None, hm.g1_mul(hm.G1_GEN, 5)]
    acc, U = None, []
    for b in range(scans.N_BUCKET_SLOTS):
        if b in buckets:
            acc = hm.g1_add(acc, hm.g1_mul(hm.G1_GEN, buckets[b]))
        U.append(hm.g1_add(acc, hm.g1_neg(offs[b % 2])))
    idx = torch.arange(scans.N_BUCKET_SLOTS, dtype=torch.int32, device=device)
    return (cv.g1_to_device(U, device), cv.g1_to_device(offs, device), idx, idx % 2,
            torch.full_like(idx, int(valid), dtype=torch.bool))


def weighted_oracle(buckets: dict) -> list:
    """[(sum_b b k_b) G1] as an affine point (None for infinity)."""
    k = sum(b * v for b, v in buckets.items()) % hm.R
    return [hm.g1_mul(hm.G1_GEN, k) if k else None]
