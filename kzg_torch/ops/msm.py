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
       last position
    7. sum_b b S_b by a 3-axis digit grid (b = 2^10 u + 2^5 v + w), suffix-
       weighted sums and a Horner combine
  Stages 6-7 are one kernel in three launches (``bucket_reduce``,
  csrc/bucket_reduce.cu) from the scan's prefixes, the offsets and the
  per-bucket gather indices; ``bucket_reduce_plain`` is the same composition
  on the plain point formulas, add for add. Sorting, searchsorted, the digit
  rewrite and the index gathers (``bucket_indices``) are data movement and
  stay plain PyTorch, as they were XLA outside Pallas in the JAX package;
  the scan reads its table points itself.
"""

from __future__ import annotations

import torch

from . import _build
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
# the bucket reduction kernel's scratch: V, its grid sums and its row sums
# (then one int, a counter)
BR_SCRATCH_POINTS = (1 << 15) + 1 + 2 * _GRID * _GRID + 3 * _GRID
# (add, double, suffix scan) of the reduction's plain version
PLAIN_OPS = (cv.g1_add_plain, cv.g1_double_plain, scans.hs_scan_points_plain)


def _pow2_width(n: int) -> int:
    return 1 << max(6, (n - 1).bit_length())


def tree_reduce(pts, add=None):
    """Sum Jacobian points along the last axis: a halving tree of batched
    adds (odd widths take one infinity lane), K2's add unless ``add`` is
    given. Returns the batch without that axis."""
    add = add or cv.g1_add
    while pts[0].shape[-1] > 1:
        n = pts[0].shape[-1]
        if n % 2:
            pts = tuple(torch.nn.functional.pad(c, (0, 1)) for c in pts)
            n += 1
        half = n // 2
        pts = add(tuple(c[..., :half].contiguous() for c in pts),
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
# Stages 3-6: sort, scan, and the bucket gathers
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


def bucket_indices(ds, m: int):
    """Stage 6's gathers (data movement): for each bucket b in [0, 2^15] the
    last sorted position lpos with digit <= b. Returns (slot, c, valid), each
    (2^15 + 1,): slot = ds[lpos], the U slot holding that position's chunk
    prefix (int32), c = lpos // m, its chunk (int32), valid = lpos >= 0."""
    b = torch.arange(scans.N_BUCKET_SLOTS, dtype=ds.dtype, device=ds.device)
    lpos = torch.searchsorted(ds, b, right=True) - 1
    lc = lpos.clamp(min=0)
    return ds[lc], (lc // m).to(torch.int32), lpos >= 0


# ---------------------------------------------------------------------------
# Stages 6-7: the bucket reduction, sum_b b S_b
# ---------------------------------------------------------------------------


def bucket_sums(U, off, slot, c, valid, add=cv.g1_add_plain):
    """Stage 6: S_b for b in [0, 2^15] from global prefix differences:
    V_b = U[slot_b] + off[c_b] (the chunk prefix at the last position with
    digit <= b, plus its chunk's offset), infinity where not valid;
    S_b = V_b - V_(b-1). Returns a (12, 2^15 + 1) Jacobian triple."""
    Ub = tuple(u[:, slot.long()] for u in U)
    O = tuple(o[:, c.long()] for o in off)
    V = cv.select(valid, add(Ub, O), cv.inf_like(Ub))
    Vprev = tuple(torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=1) for v in V)
    return add(V, cv.neg(Vprev))


def weighted_bucket_sum(S, ops=PLAIN_OPS):
    """Stage 7: sum_b b S_b for the signed buckets b in [0, 2^15]. With
    b = 2^10 u + 2^5 v + w: T1[u, v] = sum_w S, T2[v, w] = sum_u S, then
    A_u, B_v, C_w as row sums of those grids (halving trees of 32); each row
    weighted by its index as sum_j T_j - T_0 over its suffix sums T_j
    (sum_j T_j = sum_k (k + 1) X_k); and a Horner combine
    2^15 S_top + 2^10 W_A + 2^5 W_B + W_C. ops = (add, double, suffix scan)."""
    add, double, scan = ops
    side = _GRID
    g = tuple(c[:, : 1 << 15].reshape(FP.L, side, side, side) for c in S)  # [u, v, w]
    first = tree_reduce(tuple(torch.stack([c, c.permute(0, 2, 3, 1)], dim=1).contiguous()
                              for c in g), add)  # (12, 2, 32, 32): T1[u, v], T2[v, w]
    rows = tree_reduce(tuple(
        torch.stack([c[:, 0], c[:, 0].transpose(1, 2), c[:, 1].transpose(1, 2)], dim=1).contiguous()
        for c in first), add)  # (12, 3, 32): A_u, B_v, C_w
    T = scan(*rows, reverse=True)
    ws = add(tree_reduce(T, add), cv.neg(tuple(c[..., 0].contiguous() for c in T)))  # (12, 3)
    acc = tuple(c[:, 1 << 15 :].contiguous() for c in S)  # S_top, (12, 1)
    for k in range(3):
        for _ in range(5):
            acc = double(acc)
        acc = add(acc, tuple(c[:, k : k + 1].contiguous() for c in ws))
    return tuple(c[:, 0] for c in acc)


def bucket_reduce_plain(U, off, slot, c, valid, ops=PLAIN_OPS):
    """Plain version of the bucket reduction (any device): stage 6, then
    stage 7, on the plain point formulas and K4's plain scan. ops = (add,
    double, suffix scan) replaces them: with the K2 and K4 wrappers it is the
    multi-launch route the kernel replaced. Returns the Jacobian sum_b b S_b,
    a triple of (12,) words."""
    return weighted_bucket_sum(bucket_sums(U, off, slot, c, valid, ops[0]), ops)


def _trees_plain(p):
    """The kernel's trees on (12, sums, 32) points: at distance s = 16, 8,
    .., 1, element i < s of each sum adds element i + s into its own.
    Returns element 0 of each sum."""
    for s in (16, 8, 4, 2, 1):
        i = torch.arange(s, device=p[0].device)
        low = cv.g1_add_plain(tuple(c[..., i] for c in p), tuple(c[..., i + s] for c in p))
        p = tuple(torch.cat([lo, c[..., s:]], dim=-1) for lo, c in zip(low, p))
    return tuple(c[..., 0] for c in p)


def bucket_reduce_layout_plain(U, off, slot, c, valid):
    """bucket_reduce_plain in the kernel's layout (csrc/bucket_reduce.cu):
    which grid sum and element reads which b, which grid sums each row sum
    reads, each element's partner at each tree and scan level, and where
    S_top and T_0 come from. Equal to it bit for bit."""
    dev = slot.device
    add = cv.g1_add_plain
    side, n1 = _GRID, _GRID * _GRID
    # bucket_v: V_b for every b
    Ub = tuple(x[:, slot.long()] for x in U)
    V = cv.select(valid, add(Ub, tuple(x[:, c.long()] for x in off)), cv.inf_like(Ub))

    def s_at(b):  # S_b from V_b and V_(b-1), V_(-1) infinity
        prev = tuple(torch.where(b > 0, x[:, (b - 1).clamp(min=0)], 0) for x in V)
        return add(tuple(x[:, b] for x in V), cv.neg(prev))

    # bucket_grid: sum k < 1024 is T1[u, v] (k = 32 u + v, element w), sum
    # 1024 + 32 v + w is T2[v, w] (element u)
    k = torch.arange(2 * n1, device=dev)[:, None]
    e = torch.arange(side, device=dev)[None]
    b = torch.where(k < n1, side * k + e, n1 * e + k - n1)
    grid = _trees_plain(tuple(x.view(FP.L, 2 * n1, side) for x in s_at(b.reshape(-1))))
    # bucket_rows: row sum 32 row + i, element j: A_i from T1[i, j], B_i
    # from T1[j, i], C_i from T2[j, i]
    r = torch.arange(3 * side, device=dev)[:, None]
    row, i = r // side, r % side
    idx = torch.where(row == 0, side * i + e, torch.where(row == 1, side * e + i, n1 + side * e + i))
    rows = _trees_plain(tuple(x[:, idx] for x in grid))  # (12, 96)
    # the tail: warps 0-2 the suffix sums (lane j adds lane j + s, if any),
    # T_0 from lane 0, the tree; warp 3's lane 0 S_top and its 5 doublings;
    # then the Horner on one thread
    x = tuple(t.view(FP.L, 3, side) for t in rows)
    s = 1
    while s < side:
        lanes = torch.arange(side - s, device=dev)
        low = add(tuple(t[..., lanes] for t in x), tuple(t[..., lanes + s] for t in x))
        x = tuple(torch.cat([lo, t[..., side - s :]], dim=-1) for lo, t in zip(low, x))
        s *= 2
    ws = add(_trees_plain(x), cv.neg(tuple(t[..., 0] for t in x)))  # (12, 3)
    acc = s_at(torch.tensor([1 << 15], device=dev))
    for _ in range(5):
        acc = cv.g1_double_plain(acc)
    for j in range(3):
        if j:
            for _ in range(5):
                acc = cv.g1_double_plain(acc)
        acc = add(acc, tuple(t[:, j : j + 1] for t in ws))
    return tuple(t[:, 0] for t in acc)


def bucket_reduce(U, off, slot, c, valid):
    """Stages 6-7 as one kernel: sum_b b S_b from the fused scan's U (3 x
    (12, 2^15 + 1)), K4's exclusive chunk offsets off (3 x (12, C)) and
    bucket_indices' slot, c (int32) and valid (bool), each (2^15 + 1,).
    CPU tensors take bucket_reduce_plain; CUDA tensors launch
    ``kzg_bucket_v``, ``kzg_bucket_grid`` and ``kzg_bucket_rows``
    (csrc/bucket_reduce.cu, three launches counted as ``bucket_reduce``),
    whose output equals the plain version's word for word. Returns a
    Jacobian triple of (12,) words."""
    nb = scans.N_BUCKET_SLOTS
    if any(u.shape != (FP.L, nb) for u in U) or any(t.shape != (nb,) for t in (slot, c, valid)):
        raise ValueError(f"the bucket reduction takes {nb} bucket slots")
    if off[0].dim() != 2 or any(o.shape != off[0].shape for o in off) or off[0].shape[0] != FP.L:
        raise ValueError("chunk offsets must share one (12, C) shape")
    if U[0].device.type == "cpu":
        return bucket_reduce_plain(U, off, slot, c, valid)
    _build.check_cuda(*U, *off, slot, c)
    if valid.dtype != torch.bool or valid.device != slot.device or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous bool tensor on the operands' device")
    dev = slot.device
    scratch = torch.empty(BR_SCRATCH_POINTS * 3 * FP.L + 1, dtype=torch.int32, device=dev)
    out = torch.empty(3, FP.L, dtype=torch.int32, device=dev)
    _build.launch("bucket_reduce", "kzg_bucket_v", *(t.data_ptr() for t in U + off),
                  slot.data_ptr(), c.data_ptr(), valid.data_ptr(), scratch.data_ptr(), nb,
                  off[0].shape[1])
    _build.launch("bucket_reduce", "kzg_bucket_grid", scratch.data_ptr())
    _build.launch("bucket_reduce", "kzg_bucket_rows", scratch.data_ptr(), out.data_ptr())
    return out[0], out[1], out[2]


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
    off = scans.hs_scan_points(*totals, exclusive=True)
    return bucket_reduce(U, off, *bucket_indices(ds, m))
