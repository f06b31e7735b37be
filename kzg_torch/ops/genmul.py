"""Fixed-generator scalar multiplication through window tables, for G1 and
G2, and the G1 powers-of-tau ceremony built on it.

Counterpart of ``kzg_tpu/ops/genmul.py``. With the base fixed to a group's
generator G, the tables

    T[w][d] = d 2^(8w) G        (w < 32 windows, d < 256 entries)

are built once per group and device (seven batched mixed adds, K2 for G1
and K9 for G2, then one affine conversion), and then

    k G = sum_w T[w][digit_w(k)]

is one fold of 32 table entries per scalar. G1's fold is kernel K5/K8
(``csrc/gen_fold.cu``) on CUDA tensors and its plain version on CPU tensors;
G2's is the JAX package's fold (``kzg_tpu/ops/genmul.py:179-202``): window
0's entry as the start, then 31 mixed adds (K9) with the digit-0 lanes kept
by a select. Entry d = 0 is the identity, stored as (0, 0): no affine point
of either curve has x = y = 0, so the fold skips exactly the all-zero
entries.
"""

from __future__ import annotations

import math

import torch

from . import _build
from . import curve as cv
from . import fp2
from . import poly as polyops
from .field import FP, FR
from ..utils.device import resolve_device

GEN_WINDOW_BITS = 8
GEN_WINDOWS = 32  # 256 / GEN_WINDOW_BITS
GEN_ENTRIES = 1 << GEN_WINDOW_BITS
# Below this batch a process that has not built the tables runs the group's
# generator ladder (curve.g1_gen_ladder / g2_gen_ladder, one launch): the
# one-time build only pays off over hundreds of points.
GENMUL_TABLE_THRESHOLD = 512


def _level_bases(k: int, group=cv.G1) -> list:
    """Host-exact affine points [2^(8w + k) G for w < 32]."""
    return [cv.gen_pow2(group)[GEN_WINDOW_BITS * w + k] for w in range(GEN_WINDOWS)]


def _build_tables(device, group=cv.G1, madd=None):
    """(tx, ty): (12, 32, 256) (G1) or (12, 2, 32, 256) (G2) affine
    Montgomery words, entry d = 0 (0, 0).

    T[w][j + 2^k] = T[w][j] + 2^k base_w: one batched mixed add per bit level
    (K2 for G1, K9 for G2, or ``madd`` if given) over the 2^k entries built
    so far, as ``genmul.py:64-87``. The madd's exceptional lanes are benign:
    T[w][0] = infinity takes the (x2, y2, ONE) branch, and T[w][j] == 2^k
    base_w would need j == 2^k."""
    coord = group.coord
    madd = madd or group.madd
    bases = [group.words([c for p in _level_bases(k, group) for c in p], device)
             .view(*coord, GEN_WINDOWS, 2) for k in range(GEN_WINDOW_BITS)]
    zero = torch.zeros(*coord, GEN_WINDOWS, 1, dtype=torch.int32, device=device)
    one = group.one(zero)
    acc = (torch.cat([zero, bases[0][..., :1]], -1), torch.cat([zero, bases[0][..., 1:]], -1),
           torch.cat([zero, one], -1))  # entries [0, 1] = [infinity, base]
    for k in range(1, GEN_WINDOW_BITS):
        width = acc[0].shape[-1]
        q = tuple(bases[k][..., c : c + 1].expand(*coord, GEN_WINDOWS, width) for c in (0, 1))
        new = madd(acc, q)
        acc = tuple(torch.cat([a, b], -1) for a, b in zip(acc, new))
    (tx, ty), _ = group.to_affine(acc)
    return tx.contiguous(), ty.contiguous()


_tables: dict[tuple, tuple] = {}  # (group, device) -> tables


def gen_tables(device=None, group=cv.G1):
    """A group's generator tables on ``device``, built on first use and kept."""
    key = (group, str(resolve_device(device)))
    if key not in _tables:
        _tables[key] = _build_tables(torch.device(key[1]), group)
    return _tables[key]


def tables_built(device=None, group=cv.G1) -> bool:
    return (group, str(resolve_device(device))) in _tables


def _digits8(k: torch.Tensor) -> torch.Tensor:
    """(8, *batch) standard-form Fr words -> (32, *batch) int64 8-bit digits,
    least significant first: digit i = (k[i // 4] >> 8 (i % 4)) & 0xFF. The
    mask makes the arithmetic shift of a negative int32 word harmless."""
    k64 = k.to(torch.int64)
    d = torch.stack([(k64 >> (8 * j)) & 0xFF for j in range(4)], dim=1)
    return d.reshape((4 * k.shape[0],) + tuple(k.shape[1:]))


# ---------------------------------------------------------------------------
# K5 / K8: the window fold. Plain versions and wrappers.
# ---------------------------------------------------------------------------


def _fold_plain(entries, n: int, device):
    """acc <- acc + q over the (x, y) entries in order, from infinity, with
    the exact madd; an all-zero entry keeps the old accumulator."""
    acc = tuple(torch.zeros(FP.L, n, dtype=torch.int32, device=device) for _ in range(3))
    for qx, qy in entries:
        skip = FP.is_zero(qx) & FP.is_zero(qy)
        acc = cv.select(skip, acc, cv.g1_madd_plain(acc, (qx, qy)))
    return acc


def gen_fold_plain(tx, ty, digits):
    """Plain K5: gather T[w][digits[w]] per lane, fold the 32 entries."""
    n = digits.shape[1]
    return _fold_plain(((tx[:, w, digits[w]], ty[:, w, digits[w]]) for w in range(GEN_WINDOWS)),
                       n, digits.device)


def gen_fold_warp_plain(tx, ty, digits):
    """Plain K5 in the kernel's order: the lanes padded to whole warps of 32
    (digit 0 past n); in window 0 the entry itself, as the madd from
    infinity gives it; after it the fast madd, the doubling computed only
    for the warps that have a lane needing it, and the skip of the (0, 0)
    entry. Equal to gen_fold_plain word for word."""
    n = digits.shape[1]
    lanes = -(-n // 32) * 32
    d = torch.zeros(GEN_WINDOWS, lanes, dtype=torch.int64, device=digits.device)
    d[:, :n] = digits
    acc = tuple(torch.zeros(FP.L, lanes, dtype=torch.int32, device=digits.device)
                for _ in range(3))
    for w in range(GEN_WINDOWS):
        qx, qy = tx[:, w, d[w]], ty[:, w, d[w]]
        skip = FP.is_zero(qx) & FP.is_zero(qy)
        if w == 0:  # every acc is infinity: the madd's output is (qx, qy, ONE)
            acc = cv.select(skip, acc, (qx, qy, FP.one_like(qx)))
            continue
        out, need = cv.g1_madd_plain(acc, (qx, qy), fast=True)
        need = need & ~skip
        if bool(need.view(-1, 32).any(1).any()):
            out = cv.select(need, cv.g1_double_plain(acc), out)
        acc = cv.select(skip, acc, out)
    return tuple(c[:, :n] for c in acc)


def fold_entries_plain(xs, ys):
    """Plain K8: fold the pre-gathered entries xs[w], ys[w] (W, 12, C)."""
    return _fold_plain(zip(xs, ys), xs.shape[2], xs.device)


def gen_fold(tx, ty, digits):
    """K5: per lane i, sum_w T[w][digits[w, i]] as a Jacobian (12, n)
    triple. tx, ty (12, 32, 256) tables; digits (32, n) integers in
    [0, 256). CPU tensors take the plain version; CUDA tensors launch
    ``kzg_gen_fold`` (csrc/gen_fold.cu), which gathers from the tables
    itself."""
    if tx.shape != (FP.L, GEN_WINDOWS, GEN_ENTRIES) or ty.shape != tx.shape:
        raise ValueError(f"tables must be ({FP.L}, {GEN_WINDOWS}, {GEN_ENTRIES})")
    if digits.dim() != 2 or digits.shape[0] != GEN_WINDOWS:
        raise ValueError(f"digits must be ({GEN_WINDOWS}, n)")
    n = digits.shape[1]
    if n and bool(((digits < 0) | (digits >= GEN_ENTRIES)).any()):  # one host sync
        raise ValueError(f"digits must lie in [0, {GEN_ENTRIES})")
    if tx.device.type == "cpu":
        return gen_fold_plain(tx, ty, digits.to(torch.int64))
    digits = digits.to(torch.int32).contiguous()
    _build.check_cuda(tx, ty, digits)
    out = tuple(torch.empty(FP.L, n, dtype=torch.int32, device=tx.device) for _ in range(3))
    if n:
        _build.launch("gen_fold", "kzg_gen_fold", tx.data_ptr(), ty.data_ptr(), digits.data_ptr(),
                      *(o.data_ptr() for o in out), n)
    return out


def fold_entries(xs, ys):
    """K8: per lane, the sum of the W affine entries (xs[w], ys[w]) that are
    not (0, 0), as a Jacobian (12, C) triple. xs, ys (W, 12, C). CPU tensors
    take the plain version; CUDA tensors launch ``kzg_fold_entries``."""
    if xs.dim() != 3 or xs.shape[1] != FP.L or ys.shape != xs.shape:
        raise ValueError(f"entries must be (W, {FP.L}, C)")
    if xs.device.type == "cpu":
        return fold_entries_plain(xs, ys)
    xs, ys = xs.contiguous(), ys.contiguous()
    _build.check_cuda(xs, ys)
    W, _, C = xs.shape
    out = tuple(torch.empty(FP.L, C, dtype=torch.int32, device=xs.device) for _ in range(3))
    if C:
        _build.launch("fold_entries", "kzg_fold_entries", xs.data_ptr(), ys.data_ptr(),
                      *(o.data_ptr() for o in out), W, C)
    return out


# ---------------------------------------------------------------------------
# [k] G and the ceremony
# ---------------------------------------------------------------------------


def fold_g2(tx, ty, digits, madd=None):
    """G2's fold (``kzg_tpu/ops/genmul.py:179-202``): per lane i, window 0's
    entry T[0][digits[0, i]] as the start (infinity where the digit is 0),
    then acc + T[w][digits[w, i]] for w = 1 .. 31 by the mixed add (K9, or
    ``madd`` if given), a select keeping acc where the digit is 0 (the madd
    there takes the (0, 0) entry and its output is dropped). tx, ty
    (12, 2, 32, 256); digits (32, n) int64. Returns (12, 2, n) Jacobian."""
    madd = madd or cv.g2_madd
    nz = digits != 0
    x0, y0 = tx[:, :, 0, digits[0]], ty[:, :, 0, digits[0]]
    acc = (x0, torch.where(nz[0], y0, 0), torch.where(nz[0], fp2.one(x0), 0))
    for w in range(1, GEN_WINDOWS):
        q = (tx[:, :, w, digits[w]], ty[:, :, w, digits[w]])
        acc = cv.select(nz[w], madd(acc, q), acc)
    return acc


# K5 for G1, the JAX package's fold on K9 for G2; looked up when called, as
# curve.Group's kernels are
_FOLDS = {"G1": lambda *a: gen_fold(*a), "G2": lambda *a: fold_g2(*a)}


def mul_gen(k: torch.Tensor, tables=None, group=cv.G1):
    """[k] G for standard-form Fr words k (8, *batch): a Jacobian triple of
    (12, *batch) (G1) or (12, 2, *batch) (G2) words, through the group's
    window tables (built on k's device if not given). The same group
    elements as the 256-step ladder."""
    tx, ty = tables if tables is not None else gen_tables(k.device, group)
    batch = tuple(k.shape[1:])
    digits = _digits8(k).reshape(GEN_WINDOWS, math.prod(batch))
    out = _FOLDS[group.name](tx, ty, digits)
    return tuple(c.reshape(group.coord + batch) for c in out)


def mul_gen_auto(k: torch.Tensor, group=cv.G1):
    """[k] G through the group's tables when they exist on k's device or the
    batch amortizes building them (GENMUL_TABLE_THRESHOLD), else through the
    group's generator ladder (the scalar split into 4-bit pieces on
    constant bases, one launch). The same group elements either way."""
    batch = tuple(k.shape[1:])
    nb = math.prod(batch)
    if tables_built(k.device, group) or nb >= GENMUL_TABLE_THRESHOLD:
        return mul_gen(k, group=group)
    out = group.gen_ladder(k.reshape(FR.L, nb))
    return tuple(c.reshape(group.coord + batch) for c in out)


def mul_g1_gen(k: torch.Tensor):
    """[k] G1 (see mul_gen_auto)."""
    return mul_gen_auto(k, cv.G1)


def mul_g2_gen(k: torch.Tensor):
    """[k] G2 (see mul_gen_auto)."""
    return mul_gen_auto(k, cv.G2)


def chunked_srs_g1(s: int, n: int, chunk: int = 1 << 16, device=None):
    """The affine SRS points s^i G1 for i < n as (12, n) Montgomery words
    (x, y) on the device, made chunk by chunk: the chunk's powers (one power
    ladder, shifted by s^lo), the window fold, one affine conversion. The
    last chunk is computed at full width and cut, as the JAX package pads
    its ragged tail. Parallelizes the reference's serial setup iterator
    (src/trusted_setup.rs:40-78)."""
    if n < 1 or chunk < 1:
        raise ValueError("the ceremony needs n >= 1 points and chunk >= 1")
    device = resolve_device(device)
    chunk = min(chunk, n)
    tables = gen_tables(device)
    s_mont = FR.tensor([s], device)
    ladder = polyops.power_sequence(s_mont[:, 0], chunk)  # s^0 .. s^(chunk-1)
    step = FR.mul(ladder[:, -1:], s_mont)  # s^chunk
    base = FR.const("ONE", device)
    xs, ys = [], []
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        pw = FR.mul(ladder, base)
        base = FR.mul(base, step)
        (cx, cy), inf = cv.to_affine(mul_gen(FR.from_mont(pw), tables))
        # s^i mod r is never 0, so no SRS point is the identity: an infinity
        # lane is an upstream fault and must not be encoded as (0, 0)
        if bool(inf.any()):
            raise AssertionError("SRS ceremony produced a point at infinity")
        xs.append(cx[:, :m])
        ys.append(cy[:, :m])
    return torch.cat(xs, dim=1), torch.cat(ys, dim=1)
