"""The window fold's exceptional lanes (``ops.genmul.gen_fold``, K5, and K8
on the entries they gather), as the tests and the on-card smoke check build
them: (32, n) window digits, seeded, whose first lanes are the cases, and the
host oracle k G of any lane."""

from __future__ import annotations

import numpy as np
import torch

from . import hostmath as hm

WINDOWS = 32

# S = 0x74 2^248 - r, below 2^248: a lane with S's bytes in windows 0-30 and
# 0x74 in window 31 reaches the partial sum S G just as it meets the entry
# T[31][0x74] = (0x74 2^248 mod r) G = S G, so the exact madd doubles; the
# lane's value is 2 S G.
COLLIDE = 0x74 * (1 << 248) - hm.R
COLLIDE_DIGITS = [(COLLIDE >> (8 * w)) & 0xFF for w in range(WINDOWS - 1)] + [0x74]

# lane -> its case: lane 0 the doubling lane (so that n = 1 doubles), lane 1
# the all-zero scalar (infinity), lane 2 k = r - 1, lanes 3 + w a zero digit
# in window w (seeded elsewhere), lanes 35-37 doubling lanes again (warp 1
# holds three, between lanes that do not double)
ZERO_DIGIT_LANES = range(3, 3 + WINDOWS)
DOUBLING_LANES = (0, 35, 36, 37)
CASE_LANES = 38


def scalar_digits(k: int) -> list:
    """The 32 8-bit window digits of a 256-bit k, least significant first."""
    return [(k >> (8 * w)) & 0xFF for w in range(WINDOWS)]


def fold_digits(n: int, seed: int, device) -> torch.Tensor:
    """(32, n) int32 digits, uniform in [0, 256) from ``seed``, with the
    cases in the first min(n, CASE_LANES) lanes."""
    d = np.random.default_rng(seed).integers(0, 256, (WINDOWS, n)).astype(np.int32)
    cases = {0: COLLIDE_DIGITS, 1: [0] * WINDOWS, 2: scalar_digits(hm.R - 1)}
    cases.update({lane: COLLIDE_DIGITS for lane in DOUBLING_LANES})
    for lane, digits in cases.items():
        if lane < n:
            d[:, lane] = digits
    for w, lane in enumerate(ZERO_DIGIT_LANES):
        if lane < n:
            d[w, lane] = 0
    return torch.from_numpy(d).to(device)


def lane_scalar(digits: torch.Tensor, lane: int) -> int:
    """sum_w d_w 2^(8w) of one lane of (32, n) digits."""
    return sum(int(d) << (8 * w) for w, d in enumerate(digits[:, lane].tolist()))


def oracle(digits: torch.Tensor, lanes) -> list:
    """The affine points k G of the given lanes (None for infinity)."""
    ks = [lane_scalar(digits, lane) % hm.R for lane in lanes]
    return [hm.g1_mul(hm.G1_GEN, k) if k else None for k in ks]
