"""Batched point decompression (ZCash convention) for G1 and G2, as in
``kzg_tpu/ops/codec.py``.

Parsing (the flags, the infinity encoding, x < p) is numpy over the joined
bytes of every blob: the first blob that fails raises the JAX package's
message for its first failing check, as its per-blob Python loop does
(``kzg_tpu/ops/codec.py:54-67`` for G1, ``:124-139`` for G2). The square
roots run on the device as constant exponentiations, their products on K1:
G1's y = (x^3 + 4)^((p + 1) / 4), G2's by the p = 3 mod 4 method in Fp2
(two exponentiations, ``:183-214``). The sign follows the lexicographic
convention (G2: c1 first, c0 where c1 = 0). With ``subgroup_check`` every
point is held to [r] P == infinity by ``curve.mul_scalar``: one launch of the
group's ladder kernel (254 doublings and 133 mixed adds a lane: r has 255
bits, 134 of them set).
"""

from __future__ import annotations

import numpy as np
import torch

from . import curve as cv
from . import fp2
from .field import FP
from ..errors import SerializationError
from ..utils import hostmath as hm
from ..utils.device import resolve_device

_FLAG_COMPRESSED = 0x80
_FLAG_INFINITY = 0x40
_FLAG_SIGN = 0x20
_HALF_P = (hm.P - 1) // 2
_P_WORDS = np.array([(hm.P >> (32 * j)) & 0xFFFFFFFF for j in range(FP.L)], np.uint32)
_MESSAGES = {2: "Expected compressed encoding", 3: "Malformed infinity encoding",
             4: "x coordinate not in field"}


def _be_words(fields: np.ndarray) -> np.ndarray:
    """(n, 48) big-endian field bytes -> (n, 12) little-endian u32 words."""
    return np.ascontiguousarray(fields[:, ::-1]).view("<u4")


def _not_below_p(words: np.ndarray) -> np.ndarray:
    """(n, 12) u32 words -> (n,) x >= p, compared from the top word down."""
    diff = words != _P_WORDS
    top = FP.L - 1 - np.argmax(diff[:, ::-1], axis=1)
    above = words[np.arange(len(words)), top] > _P_WORDS[top]
    return ~diff.any(axis=1) | above


def _parse(blobs, width: int):
    """The blobs as an (n, width) uint8 array, x's words, the sign and
    infinity flags; raises on the first malformed blob."""
    blobs = [bytes(b) for b in blobs]
    n = len(blobs)
    lens = np.fromiter(map(len, blobs), np.int64, n)
    raw = np.zeros((n, width), np.uint8)
    good = np.flatnonzero(lens == width)
    raw[good] = np.frombuffer(b"".join(blobs[i] for i in good), np.uint8).reshape(-1, width)
    flags = raw[:, 0]
    inf = (flags & _FLAG_INFINITY) != 0
    malformed = inf & (((flags & (_FLAG_SIGN | 0x1F)) != 0) | raw[:, 1:].any(axis=1))
    fields = raw.copy()
    fields[:, 0] &= 0x1F
    xw = [_be_words(fields[:, k : k + 48]) for k in range(0, width, 48)]
    big = np.logical_or.reduce([_not_below_p(w) for w in xw])
    # each blob's first failing check, in the JAX package's order
    code = np.select([lens != width, (flags & _FLAG_COMPRESSED) == 0, malformed, ~inf & big],
                     [1, 2, 3, 4], 0)
    if code.any():
        i = int(np.argmax(code != 0))
        if code[i] == 1:
            raise SerializationError(f"Invalid length, expected {width}, got {lens[i]}")
        raise SerializationError(_MESSAGES[int(code[i])])
    signs = (flags & _FLAG_SIGN) != 0
    return xw, signs, inf


def _words(w: np.ndarray, device) -> torch.Tensor:
    """(n, 12) u32 words -> (12, n) int32 on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(w.T).view(np.int32)).to(device)


def parse_g1_compressed(blobs, device=None):
    """48-byte blobs -> (x standard-form words (12, n), signs (n,), infinity
    mask (n,)) on the device. Raises SerializationError on the first
    malformed blob (length, compression flag, infinity encoding, x >= p)."""
    device = resolve_device(device)
    (x,), signs, inf = _parse(blobs, 48)
    return _words(x, device), torch.from_numpy(signs).to(device), torch.from_numpy(inf).to(device)


def parse_g2_compressed(blobs, device=None):
    """96-byte blobs (x1 then x0, big-endian) -> (x standard-form words
    (12, 2, n), signs, infinity mask), as parse_g1_compressed."""
    device = resolve_device(device)
    (x1, x0), signs, inf = _parse(blobs, 96)
    x = torch.stack([_words(x0, device), _words(x1, device)], dim=1)
    return x, torch.from_numpy(signs).to(device), torch.from_numpy(inf).to(device)


def _gt_half(y_std: torch.Tensor) -> torch.Tensor:
    """y > (p - 1) / 2 for (12, *batch) standard-form words, as unsigned
    integers compared from the top word down."""
    w = y_std.to(torch.int64) & 0xFFFFFFFF
    gt = torch.zeros(w.shape[1:], dtype=torch.bool, device=w.device)
    eq = torch.ones_like(gt)
    for j in range(FP.L - 1, -1, -1):
        c = (_HALF_P >> (32 * j)) & 0xFFFFFFFF
        gt |= eq & (w[j] > c)
        eq &= w[j] == c
    return gt


def _jacobian(x, y, one, inf):
    """(x, y, one) with the infinity lanes all zero words."""
    return tuple(torch.where(inf, 0, c) for c in (x, y, one))


def _g1_decompress(x_std, signs, inf):
    x = FP.to_mont(x_std)
    rhs = FP.add(FP.mul(FP.square(x), x), FP.tensor([hm.B_G1], x.device))
    y = FP.pow_const(rhs, (hm.P + 1) // 4)  # the root, where there is one (p = 3 mod 4)
    on_curve = (FP.square(y) == rhs).all(dim=0)
    y = torch.where(_gt_half(FP.from_mont(y)) != signs, FP.neg(y), y)
    return _jacobian(x, y, FP.one_like(x), inf), on_curve | inf


def _g2_decompress(x_std, signs, inf):
    """y = sqrt(x^3 + 4 (1 + u)) by the p = 3 mod 4 method: a1 =
    rhs^((p - 3) / 4), x0 = a1 rhs, alpha = a1 x0; where alpha = -1 the root
    is u x0, else (1 + alpha)^((p - 1) / 2) x0."""
    x = FP.to_mont(x_std)
    rhs = fp2.add(fp2.mul(fp2.square(x), x), fp2.tensor([hm.B_G2], x.device))
    a1 = fp2.pow_const(rhs, (hm.P - 3) // 4)
    x0 = fp2.mul(a1, rhs)
    alpha = fp2.mul(a1, x0)
    ux0 = torch.stack([FP.neg(x0[:, 1]), x0[:, 0]], dim=1)
    one = fp2.one(alpha)
    is_neg1 = fp2.eq(alpha, fp2.neg(one))
    y = torch.where(is_neg1, ux0,
                    fp2.mul(fp2.pow_const(fp2.add(alpha, one), (hm.P - 1) // 2), x0))
    on_curve = fp2.eq(fp2.square(y), rhs)
    y_std = FP.from_mont(y)
    c1_zero = FP.is_zero(y_std[:, 1])
    sign = torch.where(c1_zero, _gt_half(y_std[:, 0]), _gt_half(y_std[:, 1]))
    y = torch.where(sign != signs, fp2.neg(y), y)
    return _jacobian(x, y, one, inf), on_curve | inf


def _check(jac, ok, group, subgroup_check: bool):
    if not bool(ok.all()):
        raise SerializationError("Point not on curve")
    if subgroup_check:
        if not bool(group.is_inf(cv.mul_scalar(jac, hm.R, group=group)).all()):
            raise SerializationError("Point not in the prime-order subgroup")
    return jac


def g1_decompress_batch(blobs, subgroup_check: bool = False, device=None):
    """Decompress 48-byte G1 blobs in one device batch: a Jacobian (12, n)
    triple (Z the Montgomery one, all zero words at infinity). Raises
    SerializationError if a point is off the curve or, with
    ``subgroup_check``, outside the prime-order subgroup."""
    x, signs, inf = parse_g1_compressed(blobs, device)
    return _check(*_g1_decompress(x, signs, inf), cv.G1, subgroup_check)


def g2_decompress_batch(blobs, subgroup_check: bool = False, device=None):
    """Decompress 96-byte G2 blobs in one device batch: a Jacobian
    (12, 2, n) triple, as g1_decompress_batch."""
    x, signs, inf = parse_g2_compressed(blobs, device)
    return _check(*_g2_decompress(x, signs, inf), cv.G2, subgroup_check)
