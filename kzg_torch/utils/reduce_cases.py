"""The bucket reduction's exceptional inputs (``ops.msm.bucket_reduce``), as
the tests and the on-card smoke check build them: sparse bucket sums
S_b = k_b G1 with a known weighted sum, checked against the host oracle."""

from __future__ import annotations

import torch

from . import hostmath as hm

TOP = 1 << 15
# element w = 2 of the T1 sum (u, v) = (3, 5), and element u = 0 of the T2
# sum (v, w) = (7, 9): each meets the bucket 16 elements on at a tree's
# first level
T1, T2 = 3 * 1024 + 5 * 32 + 2, 7 * 32 + 9
# {b: k_b}, S_b = k_b G1
BUCKET_CASES = {
    "every bucket empty": {},
    "only S_top": {TOP: 12345},
    "only b = 0": {0: 777},  # weight 0: infinity
    "only b = 2^15 - 1": {TOP - 1: 31},
    "equal sums in a tree": {T1: 11, T1 + 16: 11, T2: 4, T2 + 16 * 1024: 4},  # doubles
    "P and -P in a tree": {T1: 6, T1 + 16: -6},  # infinity
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
