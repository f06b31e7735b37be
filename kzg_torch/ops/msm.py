"""G1 multi-scalar multiplication: the commit MSM.

Counterpart of ``kzg_tpu/ops/msm.py``. Two paths give the same group element:

* ``msm_batched_affine``: every point through one 256-step double-and-add
  ladder at once, then a tree of adds in the JAX package's pairing (its path
  below its Pippenger threshold): one kernel in one launch (K2b,
  csrc/ladder_msm.cu); ``msm_batched_plain`` runs the same order on the
  plain point formulas, add for add.
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
    6. global prefixes V_b at each digit's last position; the bucket sums
       are S_b = V_b - V_{b-1}
    7. sum_b b S_b, which telescopes to sum_(b < 2^15) (V_top - V_b): one
       halving tree over those 2^15 leaves (the JAX package takes a 3-axis
       digit grid, suffix-weighted sums and a Horner combine instead)
  Stages 6-7 are one kernel in one launch (``bucket_reduce``,
  csrc/bucket_reduce.cu) from the scan's prefixes, the offsets and the
  per-bucket gather indices; ``bucket_reduce_plain`` adds in the kernel's
  order on the plain point formulas, add for add. Sorting, searchsorted,
  the digit rewrite and the index gathers (``bucket_indices``) are data
  movement and stay plain PyTorch, as they were XLA outside Pallas in the
  JAX package; the scan reads its table points itself.
"""

from __future__ import annotations

import torch

from . import _build
from . import curve as cv
from . import scans
from .field import FP, FR
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
BR_LEAVES = 256  # the bucket reduction's leaves a block
# its scratch: one sum a block of leaves (then one int, a counter)
BR_SCRATCH_POINTS = (1 << 15) // BR_LEAVES
LADDER_LANES = 128  # K2b's lanes a block (csrc/ladder_msm.cu kLadderThreads)


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


def tree_reduce_adjacent(pts, add=cv.g1_add_plain):
    """Sum Jacobian points (12, n) along the lanes in the JAX package's
    tree_reduce pairing: at distance s = 1, 2, 4, .., lane j adds lane
    j + s, j a multiple of 2 s. The JAX package pads the lanes to a power of
    two with infinity, where its add returns lane j unchanged; here such a
    lane is kept as it is, the same words. Returns a triple of (12,) words."""
    while pts[0].shape[-1] > 1:
        h = pts[0].shape[-1] // 2
        evens = tuple(c[:, 0::2] for c in pts)
        summed = add(tuple(c[:, :h].contiguous() for c in evens),
                     tuple(c[:, 1::2].contiguous() for c in pts))
        pts = tuple(torch.cat([a, c[:, h:]], dim=1) for a, c in zip(summed, evens))
    return tuple(c[:, 0] for c in pts)


def msm_batched_plain(pts_affine, scalars: torch.Tensor, inf_mask=None, add=cv.g1_add_plain,
                      madd=cv.g1_madd_plain, double=cv.g1_double_plain):
    """Plain version of K2b (any device), in the kernel's order: every lane's
    256-step ladder (cv.mul_scalar_affine), infinity on the lanes flagged in
    inf_mask, then tree_reduce_adjacent. That is the JAX package's
    msm_batched_affine add for add, so the words equal its. ``add``,
    ``madd`` and ``double`` replace the plain formulas: with K2's wrappers
    they replay on the card the route K2b replaced (256 doubles, 256 madds
    and ceil(log2 n) adds, one launch each). n >= 1."""
    prods = cv.mul_scalar_affine(pts_affine, scalars, double=double, madd=madd)
    if inf_mask is not None:
        prods = cv.select(inf_mask, cv.inf_like(prods), prods)
    return tree_reduce_adjacent(prods, add)


def msm_batched_affine(pts_affine, scalars: torch.Tensor, inf_mask=None):
    """K2b, sum_i scalars_i P_i: pts_affine (x, y) (12, n) affine Montgomery
    words, scalars (8, n) standard-form Fr words, inf_mask an (n,) bool
    tensor or None; flagged lanes contribute nothing. CPU tensors take
    msm_batched_plain; CUDA tensors launch ``kzg_ladder_msm``
    (csrc/ladder_msm.cu, one launch counted as ``ladder_msm``), whose output
    equals the plain version's word for word. Returns a Jacobian triple of
    (12,) words."""
    x, y = pts_affine
    n = scalars.shape[-1]
    if x.shape != (FP.L, n) or y.shape != x.shape or scalars.shape != (FR.L, n):
        raise ValueError(f"the batched MSM takes (12, n) coordinates and (8, n) scalars, got "
                         f"{tuple(x.shape)}, {tuple(y.shape)} and {tuple(scalars.shape)}")
    if inf_mask is not None and inf_mask.shape != (n,):
        raise ValueError(f"inf_mask must have shape ({n},)")
    if n == 0:
        return tuple(torch.zeros(FP.L, dtype=torch.int32, device=x.device) for _ in range(3))
    if x.device.type == "cpu":
        return msm_batched_plain(pts_affine, scalars, inf_mask)
    x, y, scalars = x.contiguous(), y.contiguous(), scalars.contiguous()
    _build.check_cuda(x, y, scalars)
    if inf_mask is not None and (inf_mask.dtype != torch.bool or inf_mask.device != x.device
                                 or not inf_mask.is_contiguous()):
        raise ValueError("inf_mask must be a contiguous bool tensor on the operands' device")
    blocks = -(-n // LADDER_LANES)
    scratch = torch.empty(blocks * 3 * FP.L + 1, dtype=torch.int32, device=x.device)
    out = torch.empty(3, FP.L, dtype=torch.int32, device=x.device)
    _build.launch("ladder_msm", "kzg_ladder_msm", x.data_ptr(), y.data_ptr(), scalars.data_ptr(),
                  None if inf_mask is None else inf_mask.data_ptr(), scratch.data_ptr(),
                  out.data_ptr(), n)
    return out[0], out[1], out[2]


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


def bucket_reduce_plain(U, off, slot, c, valid, add=cv.g1_add_plain):
    """Plain version of the bucket reduction (any device), in the kernel's
    order: V_b = U[slot_b] + off[c_b] (the chunk prefix at the last position
    with digit <= b, plus its chunk's offset), infinity where not valid; the
    leaves L_b = V_top + (-V_b) for b < 2^15 (top = 2^15); their sum by
    tree_reduce over (12, 128, BR_LEAVES), then over the 128 block sums.
    Since S_b = V_b - V_(b-1) telescopes, that sum is sum_b b S_b. ``add``
    replaces the plain add: with K2's wrapper it replays the same route on
    K2's kernel. Returns a Jacobian triple of (12,) words."""
    Ub = tuple(u[:, slot.long()] for u in U)
    V = cv.select(valid, add(Ub, tuple(o[:, c.long()] for o in off)), cv.inf_like(Ub))
    nl = V[0].shape[1] - 1
    top = tuple(v[:, nl:].expand(-1, nl).contiguous() for v in V)
    leaves = add(top, cv.neg(tuple(v[:, :nl].contiguous() for v in V)))
    blocks = tree_reduce(tuple(x.reshape(FP.L, nl // BR_LEAVES, BR_LEAVES) for x in leaves), add)
    return tree_reduce(blocks, add)


def bucket_reduce(U, off, slot, c, valid):
    """Stages 6-7 as one kernel: sum_b b S_b from the fused scan's U (3 x
    (12, 2^15 + 1)), K4's exclusive chunk offsets off (3 x (12, C)) and
    bucket_indices' slot, c (int32) and valid (bool), each (2^15 + 1,).
    CPU tensors take bucket_reduce_plain; CUDA tensors launch
    ``kzg_bucket_reduce`` (csrc/bucket_reduce.cu, one launch counted as
    ``bucket_reduce``), whose output equals the plain version's word for
    word. Returns a Jacobian triple of (12,) words."""
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
    _build.launch("bucket_reduce", "kzg_bucket_reduce", *(t.data_ptr() for t in U + off),
                  slot.data_ptr(), c.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
                  out.data_ptr(), nb, off[0].shape[1])
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
