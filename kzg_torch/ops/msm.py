"""G1 multi-scalar multiplication: the commit MSM.

Counterpart of ``kzg_tpu/ops/msm.py``. Two paths give the same group element:

* ``msm_batched_affine``: every point through one 256-step double-and-add
  ladder at once, then a halving tree of adds (the JAX package's path below
  its Pippenger threshold).
* ``msm_g1_fixed``: the fixed-base MSM against precomputed window tables
  (``precompute_g1_tables``), the commit path at n >= FIXED_BASE_THRESHOLD,
  in the stages of the JAX package's signed-digit pipeline:
    1. tables: table[w * n2 + i] = 2^(16 w) P_i, affine, one windowed
       doubling chain (K7) and one inversion; kept point-major, a row of
       24 words (x, then y) per point (``point_table``)
    2. signed 16-bit digits e_w, |e_w| <= 2^15 (a negative digit takes the
       negated table point)
    3. a sort of the 16 n2 (point, |digit|) pairs by digit, ties in pair
       order, into one int32 key per pair (row | sign bit)
    4. the chunked bucket scan (K3, fused): chunk totals, and the chunk
       prefix at each digit's last position
    5. chunk offsets: the exclusive prefix of the chunk totals (K4)
    6. bucket sums S_b = V_b - V_{b-1} from global prefixes at each digit's
       last position (K2 adds)
    7. sum_b b S_b by a 3-axis digit grid (b = 2^10 u + 2^5 v + w), suffix-
       weighted sums (K4) and a Horner combine (K2 doubles and adds)
  Sorting, searchsorted, the digit rewrite and the gathers of the bucket
  extraction are data movement and stay plain PyTorch, as they were XLA
  outside Pallas in the JAX package; the scan reads its table points itself.
"""

from __future__ import annotations

import torch

from . import curve as cv
from . import scans
from .field import FP
from .limbs import MASK16

FB_WINDOW_BITS = 16
FB_WINDOWS = 16  # 256 / FB_WINDOW_BITS
# below this the per-MSM bucket-stage overhead (~2^15 lanes of adds and the
# extraction, independent of n) outweighs the fixed-base scan's savings
FIXED_BASE_THRESHOLD = 16384
# the scan's chunk count the chunk length m aims at, one thread a chunk:
# 131,072 threads are 2.6 waves of the fused scan's 12 warps on each of an
# H100's 132 SMs. Fewer, longer chunks leave SMs idle in the last wave; more,
# shorter ones cost more chunk offsets (K4) than they save.
SCAN_CHUNKS = 1 << 17
_GRID = 32  # b = 2^10 u + 2^5 v + w with u, v, w < 32


def _pow2_width(n: int) -> int:
    return 1 << max(6, (n - 1).bit_length())


def tree_reduce(pts):
    """Sum Jacobian points along the last axis: a halving tree of batched
    adds (odd widths take one infinity lane). Returns the batch without
    that axis."""
    while pts[0].shape[-1] > 1:
        n = pts[0].shape[-1]
        if n % 2:
            pts = tuple(torch.nn.functional.pad(c, (0, 1)) for c in pts)
            n += 1
        half = n // 2
        pts = cv.g1_add(tuple(c[..., :half].contiguous() for c in pts),
                        tuple(c[..., half:].contiguous() for c in pts))
    return tuple(c[..., 0] for c in pts)


def msm_batched_affine(pts_affine, scalars: torch.Tensor, inf_mask=None):
    """sum_i scalars_i P_i: pts_affine (x, y) (12, n), scalars (8, n)
    standard-form Fr words; lanes flagged in inf_mask contribute nothing."""
    prods = cv.mul_scalar_affine(pts_affine, scalars)
    if inf_mask is not None:
        prods = cv.select(inf_mask, cv.inf_like(prods), prods)
    return tree_reduce(prods)


# ---------------------------------------------------------------------------
# Stage 1: fixed-base window tables
# ---------------------------------------------------------------------------


def precompute_g1_tables(pts_affine, inf_mask=None):
    """(x, y) (12, n) affine Montgomery words -> (tx, ty) (12, 16 n2) with
    table[w * n2 + i] = 2^(16 w) P_i, n2 the power-of-two width >= 64. Pad
    lanes and lanes flagged in inf_mask hold the generator (their digits are
    forced to 0, so they never contribute). One windowed doubling chain (K7,
    240 doublings a lane) and one batched inversion (K1) per SRS."""
    x, y = pts_affine
    n = x.shape[1]
    n2 = _pow2_width(n)
    gx, gy = cv.g1_gen_affine(x.device, n2)
    real = torch.arange(n2, device=x.device) < n
    if inf_mask is not None:
        real = real & ~torch.nn.functional.pad(inf_mask.to(x.device), (0, n2 - n))
    x = FP.select(real, torch.nn.functional.pad(x, (0, n2 - n)), gx)
    y = FP.select(real, torch.nn.functional.pad(y, (0, n2 - n)), gy)
    jac = cv.dbl_windows((x, y), FB_WINDOW_BITS, FB_WINDOWS)
    (tx, ty), _ = cv.to_affine(jac)
    return tx, ty


def point_table(tables):
    """(tx, ty) (12, P) -> the scan's point-major (P, 24) table: row p holds
    point p's x words, then its y words (96 bytes, read as six 16-byte
    pieces)."""
    tx, ty = tables
    out = torch.empty(tx.shape[1], 2 * FP.L, dtype=tx.dtype, device=tx.device)
    out[:, : FP.L] = tx.t()
    out[:, FP.L :] = ty.t()
    return out


# ---------------------------------------------------------------------------
# Stage 2: signed digits
# ---------------------------------------------------------------------------


def signed_digits(scalars: torch.Tensor):
    """(8, n) standard-form Fr words -> (abs, neg), each (16, n): signed
    window digits e_w with |e_w| <= 2^15 and sum_w e_w 2^(16 w) == k. abs is
    int64 in [0, 2^15], neg marks negative digits. The top window never
    carries out (r < 2^255 keeps d_15 + 1 < 2^15)."""
    w64 = scalars.to(torch.int64)
    d = torch.stack([w64 & MASK16, (w64 >> 16) & MASK16], dim=1).reshape(FB_WINDOWS, -1)
    absd, negd = [], []
    carry = torch.zeros_like(d[0])
    for w in range(FB_WINDOWS):
        e = d[w] + carry
        neg = e > (1 << 15)
        absd.append(torch.where(neg, (1 << 16) - e, e))
        negd.append(neg)
        carry = neg.to(torch.int64)
    return torch.stack(absd), torch.stack(negd)


def fb_chunk_size(P: int, chunk: int | None = None) -> int:
    """The scan chunk length m for a P-pair fixed-base pipeline: about
    SCAN_CHUNKS chunks, m in [64, 512]."""
    m = chunk if chunk is not None else min(512, max(64, P // SCAN_CHUNKS))
    return min(m, P)


# ---------------------------------------------------------------------------
# Stages 3-6: sort, scan, offsets, bucket sums
# ---------------------------------------------------------------------------


def sort_pairs(absd, negd):
    """Stage 3: the pairs sorted by |digit|, ties in pair order, as one sort
    of the composite key |digit| 2^33 + pair 2 + sign. Returns (keys, ds),
    both (P,) int32: keys[p] = table row | bit 31 for a negative digit, ds[p]
    the sorted |digit|."""
    P = absd.numel()
    pair = torch.arange(P, dtype=torch.int64, device=absd.device)
    comp, _ = torch.sort((absd.reshape(P) << 33) | (pair << 1) | negd.reshape(P).to(torch.int64))
    row = ((comp >> 1) & 0x7FFFFFFF).to(torch.int32)
    keys = torch.where((comp & 1) == 1, row | scans.KEY_SIGN, row)
    return keys, (comp >> 33).to(torch.int32)


def bucket_sums(totals, U, ds, m: int):
    """Stages 5-6: S_b for b in [0, 2^15] from global prefix differences:
    V_b = (chunk prefix at the last sorted position with digit <= b, slot
    ds of that position in U) + (offset of its chunk); S_b = V_b - V_{b-1}.
    Empty buckets give the identity. Returns a (12, 2^15 + 1) Jacobian
    triple."""
    off = scans.hs_scan_points(*totals, exclusive=True)
    b = torch.arange(scans.N_BUCKET_SLOTS, dtype=ds.dtype, device=ds.device)
    lpos = torch.searchsorted(ds, b, right=True) - 1
    valid = lpos >= 0
    lc = lpos.clamp(min=0)
    slot = ds[lc].long()
    c = lc // m
    Ub = tuple(u[:, slot].contiguous() for u in U)
    O = tuple(o[:, c].contiguous() for o in off)
    V = cv.select(valid, cv.g1_add(Ub, O), cv.inf_like(Ub))
    Vprev = tuple(torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=1) for v in V)
    return cv.g1_add(V, cv.neg(Vprev))


# ---------------------------------------------------------------------------
# Stage 7: sum_b b S_b
# ---------------------------------------------------------------------------


def _suffix_weighted(rows):
    """sum_k k * P_k along the last axis: T_j = sum_{k >= j} P_k (K4), then
    sum_j T_j = sum_k (k + 1) P_k, so the answer is sum_j T_j - T_0."""
    T = scans.hs_scan_points(*rows, reverse=True)
    total = tree_reduce(T)
    t0 = tuple(c[..., 0].contiguous() for c in T)
    return cv.g1_add(total, cv.neg(t0))


def weighted_bucket_sum(S):
    """sum_b b S_b for the signed buckets b in [0, 2^15]. With
    b = 2^10 u + 2^5 v + w: T1[u, v] = sum_w S, T2[v, w] = sum_u S, then
    A_u, B_v, C_w as row sums of those grids, each row weighted by its index,
    and a Horner combine 2^15 S_top + 2^10 WA + 2^5 WB + WC."""
    side = _GRID
    g = tuple(c[:, : 1 << 15].reshape(FP.L, side, side, side) for c in S)  # [u, v, w]
    first = tree_reduce(tuple(torch.stack([c, c.permute(0, 2, 3, 1)], dim=1).contiguous()
                              for c in g))  # (12, 2, 32, 32): T1[u, v], T2[v, w]
    rows = tree_reduce(tuple(
        torch.stack([c[:, 0], c[:, 0].transpose(1, 2), c[:, 1].transpose(1, 2)], dim=1).contiguous()
        for c in first))  # (12, 3, 32): A_u, B_v, C_w
    ws = _suffix_weighted(rows)  # (12, 3)
    acc = tuple(c[:, 1 << 15 :].contiguous() for c in S)  # S_top, (12, 1)
    for k in range(3):
        for _ in range(5):
            acc = cv.g1_double(acc)
        acc = cv.g1_add(acc, tuple(c[:, k : k + 1].contiguous() for c in ws))
    return tuple(c[:, 0] for c in acc)


def msm_g1_fixed(table, scalars: torch.Tensor, inf_mask=None, chunk: int | None = None):
    """G1 MSM against fixed-base tables: sum_i k_i P_i.

    table: the point-major (16 n2, 24) table (point_table of
    precompute_g1_tables); scalars: (8, n) standard-form Fr words, n <= the
    table width. Returns the Jacobian sum, a triple of (12,) words."""
    nt = table.shape[0] // FB_WINDOWS
    n = scalars.shape[-1]
    if n > nt:
        raise ValueError(f"{n} scalars for a table of {nt} points")
    absd, negd = signed_digits(scalars)
    if inf_mask is not None:
        absd = torch.where(inf_mask[None], 0, absd)
        negd = negd & ~inf_mask[None]
    absd = torch.nn.functional.pad(absd, (0, nt - n))
    negd = torch.nn.functional.pad(negd, (0, nt - n))
    P = FB_WINDOWS * nt
    m = fb_chunk_size(P, chunk)
    if P % m:
        raise ValueError(f"chunk {m} must divide the {P} pairs")
    keys, ds = sort_pairs(absd, negd)
    totals, U = scans.scan_buckets(table, keys, ds, m)
    return weighted_bucket_sum(bucket_sums(totals, U, ds, m))
