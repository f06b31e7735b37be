"""The fixed-base MSM's two scan kernels, with their plain versions.

Counterpart of ``kzg_tpu/ops/pallas_msm.py`` and ``pallas_msm25.py``:

* K3 ``scan_buckets`` (``csrc/scan_madd.cu``, fused): the commit's bucket
  scan. Per chunk of m digit-sorted pairs, the running sum of their table
  points, read from the point-major table by key; only the chunk totals and
  the prefix at each digit's last position are kept.
* K3 ``scan_prefix_madd`` (same source, streaming): per chunk, m sequential
  mixed adds over a pre-gathered affine stream, every Jacobian prefix kept
  (the function of K3a-d and K6; batch opening will call it).
* K4 ``hs_scan_points`` (``csrc/hs_scan.cu``): prefix or suffix sums of
  Jacobian points along the last axis, inclusive or exclusive, any width.

CPU tensors take the plain versions, CUDA tensors the kernels. Each plain
version repeats its kernel's order of operations, so the two agree bit for
bit on the card.
"""

from __future__ import annotations

import torch

from . import _build
from . import curve as cv
from .field import FP

HS_BLOCK = 256  # the widest row K4 scans in one block (kHsBlock in hs_scan.cu)
# K4's wide scan (W > HS_BLOCK): a segment is HS_WIDE_BLOCK threads, each
# walking HS_RUN consecutive lanes
HS_RUN = 8
HS_WIDE_BLOCK = 128


# ---------------------------------------------------------------------------
# K3: the bucket scan
# ---------------------------------------------------------------------------


def scan_prefix_madd_plain(xs: torch.Tensor, ys: torch.Tensor, fast: bool):
    """Plain version of K3 (any device). xs, ys: (m, 12, C) affine words.
    Returns (runs, flag): runs 3 x (m, 12, C) with runs[j, :, c] the sum of
    the first j + 1 points of chunk c; flag (a 0-d bool tensor) is set when
    fast and some lane met P == Q (its runs are then not the sums)."""
    m, L, C = xs.shape
    run = tuple(torch.zeros(2 * L, C, dtype=torch.int64, device=xs.device) for _ in range(3))
    runs = tuple(torch.empty(m, L, C, dtype=torch.int32, device=xs.device) for _ in range(3))
    flag = torch.zeros((), dtype=torch.bool, device=xs.device)
    for j in range(m):
        q = cv.to16((xs[j], ys[j]))
        if fast:
            run, need = cv.madd_fast16(run, q)
            flag = flag | need.any()
        else:
            run = cv.madd16(run, q)
        for out, c in zip(runs, cv.from16(run)):
            out[j] = c
    return runs, flag


def scan_prefix_madd(xs: torch.Tensor, ys: torch.Tensor, fast: bool = True):
    """K3 wrapper. xs, ys: (m, 12, C) int32 views with lane stride 1 and the
    same strides (a permuted view of a gathered (12, m, C) stream is read in
    place). CPU tensors take the plain version; CUDA tensors launch
    ``kzg_scan_madd``. Returns (runs, flag) as the plain version does."""
    if xs.shape != ys.shape or xs.dim() != 3 or xs.shape[1] != FP.L:
        raise ValueError("scan streams must share one (m, 12, C) shape")
    if xs.device.type == "cpu":
        return scan_prefix_madd_plain(xs, ys, fast)
    if xs.stride() != ys.stride() or xs.stride(2) != 1:
        raise ValueError("scan streams must share strides, with lane stride 1")
    if xs.dtype != torch.int32 or ys.dtype != torch.int32 or ys.device != xs.device:
        raise TypeError("scan streams must be int32 on one CUDA device")
    m, L, C = xs.shape
    runs = tuple(torch.empty(m, L, C, dtype=torch.int32, device=xs.device) for _ in range(3))
    flag = torch.zeros(1, dtype=torch.int32, device=xs.device)
    _build.launch("scan_madd", "kzg_scan_madd", xs.data_ptr(), ys.data_ptr(),
                  xs.stride(0), xs.stride(1), *(r.data_ptr() for r in runs),
                  flag.data_ptr(), m, C, int(fast))
    return runs, flag[0] != 0


N_BUCKET_SLOTS = (1 << 15) + 1  # one slot per signed-digit bucket b in [0, 2^15]
KEY_SIGN = -(1 << 31)  # bit 31 of an int32 key: the pair's digit is negative


def _last_of_digit(ds: torch.Tensor) -> torch.Tensor:
    """(P,) bool: position p is the last of its digit's run."""
    last = torch.ones_like(ds, dtype=torch.bool)
    last[:-1] = ds[1:] != ds[:-1]
    return last


def scan_buckets_plain(table, keys, ds, m: int, nb: int = N_BUCKET_SLOTS):
    """Plain version of the fused K3 (any device), in the kernel's order.
    table: (R, 24) point-major affine rows (x words, then y words); keys:
    (P,) int32 row | sign bit; ds: (P,) int32 sorted |digit| in [0, nb).
    Returns (totals, U): totals 3 x (12, C), the sum of each chunk of m
    pairs; U 3 x (12, nb), slot ds[p] holding chunk p // m's prefix through
    p at each digit's last position p, zeros elsewhere."""
    P = keys.numel()
    C = P // m
    rows = table[(keys & 0x7FFFFFFF).long()]
    x = rows[:, : FP.L].t()
    y = FP.select(keys < 0, FP.neg(rows[:, FP.L :].t().contiguous()), rows[:, FP.L :].t())
    last = _last_of_digit(ds)
    pos = torch.arange(P, device=keys.device).view(C, m)
    U = tuple(torch.zeros(FP.L, nb, dtype=torch.int32, device=keys.device) for _ in range(3))
    run = tuple(torch.zeros(2 * FP.L, C, dtype=torch.int64, device=keys.device) for _ in range(3))
    for j in range(m):
        p = pos[:, j]
        run = cv.madd16(run, cv.to16((x[:, p], y[:, p])))
        hit = last[p]
        if bool(hit.any()):
            slots = ds[p[hit]].long()
            for u, w in zip(U, cv.from16(tuple(c[:, hit] for c in run))):
                u[:, slots] = w
    return cv.from16(run), U


def scan_buckets(table, keys, ds, m: int, nb: int = N_BUCKET_SLOTS):
    """The fused K3 wrapper; arguments and result as scan_buckets_plain.
    CPU tensors take the plain version; CUDA tensors launch
    ``kzg_scan_buckets``, which reads each pair's row itself (rows are 96
    bytes, 16-byte aligned) and writes only the totals and the U slots.
    Keys carry the row in 31 bits, so the table has at most 2^30 rows
    (n2 <= 2^26)."""
    P = keys.numel()
    if table.dim() != 2 or table.shape[1] != 2 * FP.L:
        raise ValueError("the scan's table is (rows, 24) point-major words")
    if keys.shape != (P,) or ds.shape != (P,) or m <= 0 or P % m:
        raise ValueError(f"keys and digits must be (P,) with the chunk {m} dividing P = {P}")
    if table.shape[0] > 1 << 30:
        raise ValueError("table rows exceed 2^30 (n2 > 2^26): the key's 31 bits cannot index them")
    if table.device.type == "cpu":
        return scan_buckets_plain(table, keys, ds, m, nb)
    _build.check_cuda(table, keys, ds)
    if table.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned")
    C = P // m
    totals = tuple(torch.empty(FP.L, C, dtype=torch.int32, device=keys.device) for _ in range(3))
    U = tuple(torch.zeros(FP.L, nb, dtype=torch.int32, device=keys.device) for _ in range(3))
    _build.launch("scan_buckets", "kzg_scan_buckets", table.data_ptr(), keys.data_ptr(),
                  ds.data_ptr(), *(c.data_ptr() for c in totals + U), m, C, nb)
    return totals, U


# ---------------------------------------------------------------------------
# K4: point prefix / suffix sums
# ---------------------------------------------------------------------------


def _shift_right16(p):
    """Lanes move one step toward higher indices along the last axis;
    lane 0 becomes infinity."""
    return tuple(torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1) for c in p)


def _hs_block16(p):
    """Hillis-Steele inclusive prefix sums along the last axis, lane w adding
    lane w - 2^k at level k (the JAX package's _hs_scan_points order)."""
    W = p[0].shape[-1]
    shift = 1
    while shift < W:
        partner = tuple(torch.cat([torch.zeros_like(c[..., :shift]), c[..., :-shift]], dim=-1)
                        for c in p)
        p = cv.add16(p, partner)
        shift *= 2
    return p


def _hs_prefix16(p):
    """Plain version of K4's inclusive prefix scan on (24, R, W) limbs, in
    the kernel's grouping: one Hillis-Steele pass up to HS_BLOCK lanes;
    wider rows in segments of HS_WIDE_BLOCK runs of HS_RUN lanes: each run's
    own prefixes, a Hillis-Steele scan of the run totals within each segment,
    the segment totals scanned by this same function, then each run's offset
    (segments before, runs before) added to its prefixes. Lanes past W are
    infinity, which every add passes through unchanged."""
    W = p[0].shape[-1]
    if W <= HS_BLOCK:
        return _hs_block16(p)
    run, block = HS_RUN, HS_WIDE_BLOCK
    nseg = -(-W // (run * block))
    lanes = tuple(torch.nn.functional.pad(c, (0, nseg * block * run - W))
                  .reshape(c.shape[:-1] + (nseg, block, run)) for c in p)
    loc = [tuple(c[..., 0] for c in lanes)]  # run prefixes, each (24, R, nseg, block)
    for j in range(1, run):
        loc.append(cv.add16(loc[-1], tuple(c[..., j] for c in lanes)))
    scan = _hs_block16(loc[-1])
    seg = _shift_right16(_hs_prefix16(tuple(c[..., -1] for c in scan)))
    seg = tuple(c.unsqueeze(-1).expand_as(r) for c, r in zip(seg, scan))
    prev = _shift_right16(scan)  # the runs before, within the segment
    # each run's offset as the kernel forms it: the runs before alone in the
    # first segment, the segments before alone for a segment's first run (an
    # add would turn an infinity with other words into (0, 0, 0)); the first
    # run of the row keeps its own prefixes
    seg0 = (torch.arange(nseg, device=p[0].device) == 0).unsqueeze(-1)
    run0 = torch.arange(block, device=p[0].device) == 0
    off = cv.select(seg0, prev, cv.select(run0, seg, cv.add16(seg, prev)))
    out = [cv.select(seg0 & run0, lp, cv.add16(off, lp)) for lp in loc]
    return tuple(torch.stack([o[k] for o in out], dim=-1)
                 .reshape(p[0].shape[:-1] + (nseg * block * run,))[..., :W] for k in range(3))


def hs_scan_points_plain(x, y, z, reverse: bool = False):
    """Plain version of K4 (inclusive) on (12, R, W) words, any device."""
    p = cv.to16((x, y, z))
    if reverse:
        p = tuple(c.flip(-1) for c in p)
    p = _hs_prefix16(p)
    if reverse:
        p = tuple(c.flip(-1) for c in p)
    return cv.from16(p)


def _hs_scan_cuda(x, y, z, reverse: bool):
    _build.check_cuda(x, y, z)
    _, R, W = x.shape
    out = tuple(torch.empty_like(c) for c in (x, y, z))
    if W <= HS_BLOCK:
        _build.launch("hs_scan_points", "kzg_hs_scan_block",
                      *(c.data_ptr() for c in (x, y, z) + out), R, W, int(reverse))
        return out
    run, block = HS_RUN, HS_WIDE_BLOCK
    nseg = -(-W // (run * block))
    loc = tuple(torch.empty_like(c) for c in (x, y, z))
    runs = tuple(torch.empty(FP.L, R, nseg * block, dtype=torch.int32, device=x.device)
                 for _ in range(3))
    segs = tuple(torch.empty(FP.L, R, nseg, dtype=torch.int32, device=x.device) for _ in range(3))
    _build.launch("hs_scan_points", "kzg_hs_scan_runs",
                  *(c.data_ptr() for c in (x, y, z) + loc + runs + segs), R, W, run, block,
                  int(reverse))
    segs = _hs_scan_cuda(*segs, reverse=False)
    offs = tuple(torch.empty_like(c) for c in runs)
    _build.launch("hs_scan_points", "kzg_hs_scan_offsets",
                  *(c.data_ptr() for c in runs + segs + offs), R, W, run, block)
    _build.launch("hs_scan_points", "kzg_hs_scan_apply",
                  *(c.data_ptr() for c in loc + out + offs), R, W, run, block, int(reverse))
    return out


def hs_scan_points(x, y, z, reverse: bool = False, exclusive: bool = False):
    """K4 wrapper: prefix (or, with reverse, suffix) sums of Jacobian points
    along the LAST axis of (12, *batch, W) coordinates; exclusive shifts the
    result one lane (data movement, here in the wrapper). CPU tensors take the
    plain version, CUDA tensors launch ``kzg_hs_scan_block`` (W <= 256) or,
    for wider rows, ``kzg_hs_scan_runs``, a scan of the segment totals,
    ``kzg_hs_scan_offsets`` and ``kzg_hs_scan_apply``: four launches up to
    256 segments (W <= 262,144).

    For W <= 256 the result equals kzg_tpu's _hs_scan_points bit for bit;
    wider rows group the adds by run and segment (kernel and plain version
    alike), equal to it as group elements."""
    shape = x.shape
    W = shape[-1]
    R = x.numel() // (FP.L * W)
    flat = tuple(c.reshape(FP.L, R, W).contiguous() for c in (x, y, z))
    if x.device.type == "cpu":
        out = hs_scan_points_plain(*flat, reverse=reverse)
    else:
        out = _hs_scan_cuda(*flat, reverse=reverse)
    if exclusive:
        if reverse:
            out = tuple(torch.cat([c[..., 1:], torch.zeros_like(c[..., :1])], dim=-1)
                        for c in out)
        else:
            out = _shift_right16(out)
    return tuple(c.reshape(shape) for c in out)
