"""Batched G1 Jacobian arithmetic on word tensors.

Counterpart of the G1 half of ``kzg_tpu/ops/curve.py``. A point is an
``(X, Y, Z)`` triple of ``(12, *batch)`` int32 Fp tensors in Montgomery form,
``Z == 0`` marking infinity; an affine point is ``(x, y)`` with an
``inf`` mask beside it where lanes may be infinite.

The three formulas (double, add, madd) are kernel K2 (``csrc/g1_point.cu``,
device functions in ``csrc/g1.cuh``) on CUDA tensors and their plain versions
on CPU tensors. The plain versions below work on 16-bit limbs in int64 and
follow ``kzg_tpu/ops/curve.py:82-170`` term for term, exceptional lanes
included, so kernel, plain version and the JAX package agree bit for bit.
"""

from __future__ import annotations

import torch

from . import _build
from . import limbs as lb
from .field import FP, FR
from ..utils import hostmath as hm

# ---------------------------------------------------------------------------
# Plain versions on 16-bit limbs (tuples of (24, N) int64 tensors)
# ---------------------------------------------------------------------------


def _sel(mask, a, b):
    return torch.where(mask.unsqueeze(0), a, b)


def _sel_pt(mask, p, q):
    return tuple(_sel(mask, a, b) for a, b in zip(p, q))


def _is_zero16(a):
    return (a == 0).all(dim=0)


def double16(p):
    """dbl-2009-l (a = 0): 2M + 5S. Maps infinity to infinity."""
    F = FP
    X, Y, Z = p
    A = F.mul16(X, X)
    B = F.mul16(Y, Y)
    C = F.mul16(B, B)
    xb = F.add16(X, B)
    t = F.mul16(xb, xb)
    D0 = F.sub16(F.sub16(t, A), C)
    D = F.add16(D0, D0)
    E = F.add16(F.add16(A, A), A)
    Fq = F.mul16(E, E)
    X3 = F.sub16(Fq, F.add16(D, D))
    C2 = F.add16(C, C)
    C4 = F.add16(C2, C2)
    eightC = F.add16(C4, C4)
    Y3 = F.sub16(F.mul16(E, F.sub16(D, X3)), eightC)
    YZ = F.mul16(Y, Z)
    Z3 = F.add16(YZ, YZ)
    return (X3, Y3, Z3)


def _with_double(mask, p, out):
    """out with the lanes in mask replaced by double(p), the doubling
    computed only when some lane needs it."""
    if not bool(mask.any()):
        return out
    return _sel_pt(mask, double16(p), out)


def _on_lanes(mask, out, fn, *points):
    """out with the lanes in mask replaced by fn(*points) computed on those
    lanes alone (mask has the batch shape; each point a tuple of limbs)."""
    if bool(mask.all()):
        return fn(*points)
    if not bool(mask.any()):
        return out
    idx = mask.reshape(-1).nonzero().squeeze(1)
    sub = [tuple(c.reshape(c.shape[0], -1)[:, idx] for c in pt) for pt in points]
    res = fn(*sub)
    merged = []
    for o, r in zip(out, res):
        o = o.reshape(o.shape[0], -1).clone()
        o[:, idx] = r
        merged.append(o.reshape((o.shape[0],) + mask.shape))
    return tuple(merged)


def _add_finite16(p, q):
    """add-2007-bl on lanes where neither operand is infinity: 11M + 5S,
    P == Q doubles, P == -Q gives infinity."""
    F = FP
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = F.mul16(Z1, Z1)
    Z2Z2 = F.mul16(Z2, Z2)
    U1 = F.mul16(X1, Z2Z2)
    U2 = F.mul16(X2, Z1Z1)
    S1 = F.mul16(Y1, F.mul16(Z2, Z2Z2))
    S2 = F.mul16(Y2, F.mul16(Z1, Z1Z1))
    H = F.sub16(U2, U1)
    H2 = F.add16(H, H)
    I = F.mul16(H2, H2)
    J = F.mul16(H, I)
    dS = F.sub16(S2, S1)
    r = F.add16(dS, dS)
    V = F.mul16(U1, I)
    X3 = F.sub16(F.sub16(F.mul16(r, r), J), F.add16(V, V))
    S1J = F.mul16(S1, J)
    Y3 = F.sub16(F.mul16(r, F.sub16(V, X3)), F.add16(S1J, S1J))
    Z3 = F.mul16(F.mul16(Z1, Z2), H2)
    out = (X3, Y3, Z3)
    same_x = _is_zero16(H)
    same_y = _is_zero16(dS)
    out = _with_double(same_x & same_y, p, out)
    return _sel_pt(same_x & ~same_y, tuple(torch.zeros_like(c) for c in out), out)


def add16(p, q):
    """add-2007-bl with the exceptional lanes (curve.py:103-135). A lane with
    an infinite operand returns the other operand (p when both are), exactly
    the JAX package's last two selects, so the formula runs only on the
    lanes where both are finite."""
    p_inf, q_inf = _is_zero16(p[2]), _is_zero16(q[2])
    out = _sel_pt(q_inf, p, q)
    return _on_lanes(~p_inf & ~q_inf, out, _add_finite16, p, q)


def _madd_core16(p, q_affine):
    F = FP
    X1, Y1, Z1 = p
    X2, Y2 = q_affine
    Z1Z1 = F.mul16(Z1, Z1)
    U2 = F.mul16(X2, Z1Z1)
    S2 = F.mul16(Y2, F.mul16(Z1, Z1Z1))
    H = F.sub16(U2, X1)
    H2 = F.add16(H, H)
    I = F.mul16(H2, H2)
    J = F.mul16(H, I)
    dS = F.sub16(S2, Y1)
    r = F.add16(dS, dS)
    V = F.mul16(X1, I)
    X3 = F.sub16(F.sub16(F.mul16(r, r), J), F.add16(V, V))
    Y1J = F.mul16(Y1, J)
    Y3 = F.sub16(F.mul16(r, F.sub16(V, X3)), F.add16(Y1J, Y1J))
    Z3 = F.mul16(H2, Z1)
    out = (X3, Y3, Z3)
    same_x, same_y = _is_zero16(H), _is_zero16(dS)
    out = _sel_pt(same_x & ~same_y, tuple(torch.zeros_like(c) for c in out), out)
    return out, same_x & same_y


def _madd_finite16(p, q_affine):
    out, need = _madd_core16(p, q_affine)
    return _with_double(need, p, out)


def _madd_fast_finite16(p, q_affine):
    out, need = _madd_core16(p, q_affine)
    return out + (need.to(torch.int64).unsqueeze(0),)


def _affine_as_jac16(q_affine, ref):
    one = FP.const16("ONE", ref.device).reshape((FP.L16,) + (1,) * (ref.dim() - 1))
    return (q_affine[0], q_affine[1], one.expand_as(ref))


def madd16(p, q_affine):
    """madd-2007-bl (Z2 = 1) with the exceptional lanes: 7M + 4S
    (curve.py:137-170). A lane with p at infinity returns (x2, y2, ONE); the
    formula runs on the others. q_affine must not be a lane at infinity."""
    p_inf = _is_zero16(p[2])
    out = _affine_as_jac16(q_affine, p[0])
    return _on_lanes(~p_inf, out, _madd_finite16, p, q_affine)


def madd_fast16(p, q_affine):
    """The 11-mul madd without the inline doubling (pallas_curve._madd_pt_fast):
    returns (point, needs_double); a needs_double lane's point is not the sum."""
    p_inf = _is_zero16(p[2])
    out = _affine_as_jac16(q_affine, p[0]) + (torch.zeros_like(p[0][:1]),)
    res = _on_lanes(~p_inf, out, _madd_fast_finite16, p, q_affine)
    return res[:3], res[3][0] != 0


def to16(p):
    return tuple(lb.words_to_limbs16(c) for c in p)


def from16(p):
    return tuple(lb.limbs16_to_words(c) for c in p)


# ---------------------------------------------------------------------------
# K2: the point formulas. Plain versions on word tensors, and the wrappers.
# ---------------------------------------------------------------------------


def g1_double_plain(p):
    return from16(double16(to16(p)))


def g1_add_plain(p, q):
    return from16(add16(to16(p), to16(q)))


def g1_madd_plain(p, q_affine, fast: bool = False):
    """Plain madd; with fast=True returns (point, needs_double) like K2's fast
    launch."""
    if fast:
        out, nd = madd_fast16(to16(p), to16(q_affine))
        return from16(out), nd
    return from16(madd16(to16(p), to16(q_affine)))


def _flat(coords):
    shape = coords[0].shape
    if any(c.shape != shape for c in coords) or shape[0] != FP.L:
        raise ValueError("point coordinates must share one (12, *batch) shape")
    n = coords[0].numel() // FP.L
    flat = tuple(c.reshape(FP.L, n).contiguous() for c in coords)
    _build.check_cuda(*flat)
    return flat, shape, n


def g1_double(p):
    """K2 double: CPU tensors take the plain version, CUDA tensors launch
    ``kzg_g1_double``."""
    if p[0].device.type == "cpu":
        return g1_double_plain(p)
    flat, shape, n = _flat(p)
    out = tuple(torch.empty_like(c) for c in flat)
    _build.launch("g1_double", "kzg_g1_double", *(c.data_ptr() for c in flat + out), n)
    return tuple(o.reshape(shape) for o in out)


def g1_add(p, q):
    """K2 add (exact, every exceptional lane)."""
    if p[0].device.type == "cpu":
        return g1_add_plain(p, q)
    flat, shape, n = _flat(tuple(p) + tuple(q))
    out = tuple(torch.empty_like(c) for c in flat[:3])
    _build.launch("g1_add", "kzg_g1_add", *(c.data_ptr() for c in flat + out), n)
    return tuple(o.reshape(shape) for o in out)


def g1_madd(p, q_affine, fast: bool = False):
    """K2 mixed add of a Jacobian p and an affine q (same shape). fast=True
    runs the 11-mul formula and also returns the (batch,) needs-double mask."""
    if p[0].device.type == "cpu":
        return g1_madd_plain(p, q_affine, fast)
    flat, shape, n = _flat(tuple(p) + tuple(q_affine))
    out = tuple(torch.empty_like(c) for c in flat[:3])
    need = torch.empty(n, dtype=torch.int32, device=flat[0].device) if fast else None
    _build.launch("g1_madd", "kzg_g1_madd", *(c.data_ptr() for c in flat + out),
                  need.data_ptr() if fast else None, n)
    res = tuple(o.reshape(shape) for o in out)
    return (res, need.reshape(shape[1:]) != 0) if fast else res


# ---------------------------------------------------------------------------
# K7: the doubling chain, and its windowed form for the table build
# ---------------------------------------------------------------------------


def dbl_chain_plain(p, steps: int):
    """Plain K7: ``steps`` doublings, 2^steps p."""
    for _ in range(steps):
        p = g1_double_plain(p)
    return p


def dbl_chain(p, steps: int):
    """K7: 2^steps p for a Jacobian (12, *batch) p, steps >= 0. CPU tensors
    take the plain version; CUDA tensors launch ``kzg_dbl_chain``
    (csrc/dbl_chain.cu), which keeps the point in registers between steps."""
    if steps < 0:
        raise ValueError("steps must be >= 0")
    if p[0].device.type == "cpu":
        return dbl_chain_plain(p, steps)
    flat, shape, n = _flat(p)
    out = tuple(torch.empty_like(c) for c in flat)
    if n:
        _build.launch("dbl_chain", "kzg_dbl_chain", *(c.data_ptr() for c in flat + out),
                      steps, 0, 1, n)
    return tuple(o.reshape(shape) for o in out)


def dbl_windows_plain(p_affine, steps: int, windows: int):
    """Plain windowed K7: the loop of g1_double_plain the table build ran.
    Returns (12, windows * n) coordinates, window k = 2^(steps k) p in
    columns [k n, k n + n)."""
    x, y = p_affine
    cur = (x, y, FP.one_like(x))
    out = [cur]
    for _ in range(1, windows):
        cur = dbl_chain_plain(cur, steps)
        out.append(cur)
    return tuple(torch.cat([w[k] for w in out], dim=1) for k in range(3))


def dbl_windows(p_affine, steps: int, windows: int):
    """Windowed K7 on affine (x, y) (12, n) words (z the Montgomery one):
    2^(steps k) p for k < windows as one (12, windows * n) Jacobian triple,
    window k in columns [k n, k n + n). CPU tensors take the plain version;
    CUDA tensors launch ``kzg_dbl_chain`` once, writing each window from
    registers."""
    if steps < 0 or windows < 1:
        raise ValueError("need steps >= 0 and windows >= 1")
    x, y = p_affine
    if x.shape != y.shape or x.dim() != 2 or x.shape[0] != FP.L:
        raise ValueError("dbl_windows takes (12, n) affine coordinates")
    if x.device.type == "cpu":
        return dbl_windows_plain(p_affine, steps, windows)
    _build.check_cuda(x, y)
    n = x.shape[1]
    out = tuple(torch.empty(FP.L, windows * n, dtype=x.dtype, device=x.device) for _ in range(3))
    if n:
        _build.launch("dbl_windows", "kzg_dbl_chain", x.data_ptr(), y.data_ptr(), None,
                      *(c.data_ptr() for c in out), 0, steps, windows, n)
    return out


# ---------------------------------------------------------------------------
# The G1 group on word tensors
# ---------------------------------------------------------------------------


def is_inf(p):
    return FP.is_zero(p[2])


def select(mask, p, q):
    return tuple(FP.select(mask, a, b) for a, b in zip(p, q))


def inf_like(p):
    return tuple(torch.zeros_like(c) for c in p)


def neg(p):
    return (p[0], FP.neg(p[1]), p[2])


def to_affine(p):
    """Jacobian -> affine ((x, y), inf): one batched inversion over every
    lane. Infinity lanes return (0, 0): the inversion maps their Z = 0 to 0,
    and the products with it are 0."""
    X, Y, Z = p
    zi = FP.inv_batch(Z)
    zi2 = FP.square(zi)
    x = FP.mul(X, zi2)
    y = FP.mul(Y, FP.mul(zi, zi2))
    return (x, y), is_inf(p)


def scalar_bit(k: torch.Tensor, i: int) -> torch.Tensor:
    """Bit i (0 = LSB) of standard-form Fr words k (8, *batch)."""
    return ((k[i // 32] >> (i % 32)) & 1) == 1


def mul_scalar_affine(p_affine, k: torch.Tensor, nbits: int = 256, double=None, madd=None):
    """[k] p for affine base points: MSB-first double-and-add with mixed adds
    (curve.py:228-245), on K2's double and exact madd unless ``double`` and
    ``madd`` are given. p_affine (x, y) (12, n); k (8, n) standard-form Fr
    words. Lanes must not be infinite (callers mask them)."""
    double, madd = double or g1_double, madd or g1_madd
    x, y = p_affine
    acc = inf_like((x, x, x))
    for i in range(nbits - 1, -1, -1):
        acc = double(acc)
        acc = select(scalar_bit(k, i), madd(acc, (x, y)), acc)
    return acc


# ---------------------------------------------------------------------------
# Host <-> device points (IO boundary; exact python ints)
# ---------------------------------------------------------------------------


def g1_to_device(points, device):
    """Host affine points (x, y) or None -> Jacobian word triple (12, n)."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0); ys.append(0); zs.append(0)
        else:
            xs.append(pt[0]); ys.append(pt[1]); zs.append(1)
    return tuple(FP.tensor(v, device) for v in (xs, ys, zs))


def g1_from_device(p) -> list:
    """Jacobian word triple (12, *batch) -> list of host affine ints (None = infinity)."""
    X, Y, Z = (FP.from_words_many(c) for c in p)
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
            continue
        zi = hm.fp_inv(z)
        zi2 = zi * zi % hm.P
        out.append((x * zi2 % hm.P, y * zi2 * zi % hm.P))
    return out


def g1_gen_affine(device, n: int = 1):
    """The generator as affine Montgomery words, broadcast to (12, n)."""
    gx, gy = (FP.tensor([c], device) for c in hm.G1_GEN)
    return gx.expand(FP.L, n).contiguous(), gy.expand(FP.L, n).contiguous()


def fr_std_words(values, device) -> torch.Tensor:
    """Python-int scalars -> (8, n) standard-form Fr words."""
    return FR.tensor(values, device, mont=False)
