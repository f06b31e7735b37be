"""The scalar multiplications' exceptional inputs, for both groups, as the
tests and the on-card smoke check build them, and the host oracle of their
case lanes: Mode A of the ladder kernels (``ops.curve.g1_ladder`` /
``g2_ladder``, the signed-digit ladder), reached through
``mul_scalar_affine`` (one scalar a lane) and ``mul_scalar`` with one
python-int scalar for every lane (the codec's [r] P); and Mode B
(``g1_gen_ladder`` / ``g2_gen_ladder``, the generator's scalar split into
pieces).

Lanes past the cases hold seeded canonical words and seeded scalars: the
formulas take any canonical input, and kernel and plain version must agree
on all of it."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.field import FP, FR
from . import hostmath as hm

# Mode B's doubling: k = 2 A + r with A = 2^128 - (r mod 2^128) has low half A
# and high half A + r, the same group element, so the last level of the
# pieces' tree adds a point to itself
SPLIT_DOUBLE = hm.R + 2 * ((1 << 128) - hm.R % (1 << 128))
# one scalar a lane, on subgroup points base_i G (Mode A) or on G (Mode B):
# lane -> scalar
SCALARS = (0, 1, hm.R - 1, (1 << 256) - 1, hm.R, hm.R + 2, hm.R - 2, SPLIT_DOUBLE)
CASES = (
    "k = 0 (infinity)",
    "k = 1",
    "k = r - 1",
    "k = 2^256 - 1 (bit 255 set; its NAF's top digit is 256)",
    "k = r (acc == -P at the last step: the madd gives infinity; Mode B: the last level "
    "adds -Q to Q)",
    "k = r + 2 (the binary ladder's acc == P; Mode B: [2] G from unreduced pieces)",
    "k = r - 2 (acc == -P at the last step and its digit is -1: the exact madd doubles; "
    "the only such lane of warp 0)",
    "k = SPLIT_DOUBLE (Mode B: the last level of the pieces' tree doubles)",
)
DOUBLING_WARP = (33, 46, 62)  # three more k = r - 2 lanes, in warp 1, where n > 62
# one scalar for every lane (the codec's [r] P): lane -> point
PUBLIC = hm.R
PUBLIC_CASES = (
    "a subgroup point ([r] P is infinity)",
    "infinity (zero words)",
    "an on-curve point outside the subgroup ([r] P is not infinity)",
    "a second subgroup point",
    "G1: (0, 2), of order 3 (acc reaches P, -P and infinity inside the ladder: 23 "
    "doublings in the madd, 18 infinities, 19 starts from infinity, 7 of them at -P); "
    "G2: the off-subgroup point's negative",
)


def _mul(group, p, k: int):
    """[k] P on the host, k not reduced mod r (None for infinity)."""
    return hm._affine_mul_unreduced(hm._FP_OPS if group.name == "G1" else hm._FP2_OPS, p, k)


def _rand_words(rng, shape) -> np.ndarray:
    """Canonical Fp words of the given (12, ...) shape, as uint32."""
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    w[-1] %= np.uint32(hm.P >> (32 * (FP.L - 1)))
    return w


def _set_lane(coord: torch.Tensor, lane: int, words: torch.Tensor) -> None:
    coord[..., lane] = words[..., 0]


def _off_subgroup(group):
    """An on-curve point outside the prime-order subgroup: x = 1, 2, ..
    (G1) or (k, 0) (G2) for the first with a root."""
    k = 1
    while True:
        if group.name == "G1":
            y = hm.fp_sqrt((k ** 3 + hm.B_G1) % hm.P)
            pt = None if y is None else (k, y)
        else:
            x = (k, 0)
            y = hm.fp2_sqrt(hm.fp2_add(hm.fp2_mul(hm.fp2_sq(x), x), hm.B_G2))
            pt = None if y is None else (x, y)
        if pt is not None:
            return pt
        k += 1


def case_lanes(n: int) -> list:
    """The lanes of affine_case that hold cases (and the host oracle)."""
    return list(range(min(n, len(SCALARS)))) + [i for i in DOUBLING_WARP if i < n]


def _scalar(lane: int) -> int:
    return SCALARS[lane] if lane < len(SCALARS) else hm.R - 2


def _set_scalar(k: torch.Tensor, lane: int, s: int) -> None:
    k[:, lane] = torch.tensor([(s >> (32 * w)) & 0xFFFFFFFF for w in range(FR.L)],
                              dtype=torch.int64).to(torch.int32)


def affine_case(group, n: int, seed: int, device):
    """One scalar a lane (Mode A): ((x, y), k, base) with x, y the affine
    words of n lanes ((12, n) or (12, 2, n)), k (8, n) standard-form scalar
    words, and base {lane: b} for the case lanes, whose points are b G
    (SCALARS on lanes 0-7, k = r - 2 on DOUBLING_WARP); seeded scalars below
    r elsewhere."""
    rng = np.random.default_rng(seed)
    x, y = (torch.from_numpy(_rand_words(rng, group.coord + (n,)).view(np.int32))
            for _ in range(2))
    k = _rand_words(rng, (FR.L, n))
    k[-1] %= np.uint32(hm.R >> (32 * (FR.L - 1)))
    k = torch.from_numpy(k.view(np.int32))
    base = {}
    for lane in case_lanes(n):
        b = int(rng.integers(2, 1 << 62))
        px, py = _mul(group, group.gen, b)
        _set_lane(x, lane, group.words([px], "cpu"))
        _set_lane(y, lane, group.words([py], "cpu"))
        _set_scalar(k, lane, _scalar(lane))
        base[lane] = b
    return (x.to(device), y.to(device)), k.to(device), base


def affine_oracle(group, base: dict) -> dict:
    """lane -> [k b] G (None for infinity) on affine_case's case lanes."""
    return {lane: _mul(group, group.gen, _scalar(lane) * b % hm.R) for lane, b in base.items()}


def gen_case(n: int, seed: int, device) -> torch.Tensor:
    """Mode B's scalars: (8, n) standard-form words, SCALARS on lanes 0-7
    and seeded 256-bit scalars (not reduced) elsewhere."""
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.integers(0, 1 << 32, size=(FR.L, n), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32))
    for lane in range(min(n, len(SCALARS))):
        _set_scalar(k, lane, SCALARS[lane])
    return k.to(device)


def gen_oracle(group, k: torch.Tensor, lanes) -> list:
    """[k mod r] G (None for infinity) on the given lanes of k."""
    words = k[:, list(lanes)].to(torch.int64).cpu() & 0xFFFFFFFF
    return [_mul(group, group.gen, sum(int(words[w, j]) << (32 * w) for w in range(FR.L)) % hm.R)
            for j in range(words.shape[1])]


def public_case(group, n: int, seed: int, device):
    """One scalar for every lane (PUBLIC): a Jacobian triple of n lanes with
    Z the Montgomery one (zero words at infinity), PUBLIC_CASES on the first
    lanes, seeded words elsewhere; and the host points of the case lanes."""
    rng = np.random.default_rng(seed)
    x, y = (torch.from_numpy(_rand_words(rng, group.coord + (n,)).view(np.int32))
            for _ in range(2))
    z = group.one(x).expand_as(x).clone()
    off = _off_subgroup(group)
    fifth = (0, 2) if group.name == "G1" else (off[0], hm.fp2_neg(off[1]))
    pts = [_mul(group, group.gen, int(rng.integers(2, 1 << 62))), None, off,
           _mul(group, group.gen, int(rng.integers(2, 1 << 62))), fifth][:n]
    for lane, pt in enumerate(pts):
        for c, v in ((x, None if pt is None else pt[0]), (y, None if pt is None else pt[1])):
            if v is None:
                c[..., lane] = 0
            else:
                _set_lane(c, lane, group.words([v], "cpu"))
        if pt is None:
            z[..., lane] = 0
    return (x.to(device), y.to(device), z.to(device)), pts


def public_oracle(group, pts: list) -> list:
    """[PUBLIC] P for public_case's case points, unreduced (None for
    infinity)."""
    return [None if p is None else _mul(group, p, PUBLIC) for p in pts]
