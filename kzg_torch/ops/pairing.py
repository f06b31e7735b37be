"""The optimal ate pairing over BLS12-381: the Miller loop (K10) and the
final exponentiation (K11).

Counterpart of ``kzg_tpu/ops/pairing.py``, which runs both as XLA around
K1: every Fp product of a pairing is one ``mont_mul_pallas`` launch
through ``FP.mul`` (about 24,000 products a pairing lane, in some 1,700
stacked multiplies and many times as many adds). Here each stage is one
hand-written kernel on a CUDA tensor (``csrc/pairing.cu``, one thread a
lane) and the JAX package's formulas in plain PyTorch on a CPU tensor:

* ``miller_loop`` (K10): f_{|x|,Q}(P), conjugated for the negative BLS
  parameter (``kzg_tpu``'s ``_miller_conj``). Q runs on the twist in
  Jacobian coordinates; each step's line is the sparse Fp12
  ((a, 0, 0), (0, b, c)), scaled by an Fp2 factor the final exponentiation
  kills. A Miller value is defined only up to those factors and T's
  projective representative, so kernel and plain version use the JAX
  package's doubling (dbl-2009-l), mixed add (madd-2007-bl, H = -h,
  r = -2 n) and line scaling term for term: then their words agree.
* ``final_exponentiation`` (K11): the easy part (p^6 - 1)(p^2 + 1), then
  the canonical hard part (p^4 - p^2 + 1) / r through the exact chain
  (z - 1)^2 / 3 (z + p)(z^2 + p^2 - 1) + 1, z = -|x|: blst's GT values.

``pairing`` masks infinity lanes to one (blst: e(O, Q) = e(P, O) = 1).
"""

from __future__ import annotations

import torch

from . import _build
from . import fp2, fp12
from .field import FP
from ..utils import hostmath as hm

# the bits of |x|, LSB first: the loop runs bits nbits - 2 .. 0
_X_BITS = [(hm.BLS_X >> i) & 1 for i in range(hm.BLS_X.bit_length())]

# (z - 1)^2 / 3 with z = -BLS_X: the non-sparse factor of the canonical hard part
_E_HARD = (hm.BLS_X + 1) ** 2 // 3
assert (hm.BLS_X + 1) ** 2 % 3 == 0
_E_BITS = [(_E_HARD >> i) & 1 for i in range(_E_HARD.bit_length())]


def _line_to_fp12(a, b, c):
    """The sparse line ((a, 0, 0), (0, b, c)) as an Fp12 tensor."""
    z = torch.zeros_like(a)
    return torch.stack([torch.stack([a, z, z], dim=2), torch.stack([z, b, c], dim=2)], dim=3)


def _dbl_step(T, xP, yP):
    """Double T (Jacobian, twist) and evaluate the tangent line at P
    (``kzg_tpu/ops/pairing.py:56``). Line (scaled by 2 y' XI Z^6, all Fp2):
    a = 2 XI Y Z^3 yP, b = 3 X^3 - 2 Y^2, c = -3 X^2 Z^2 xP."""
    X, Y, Z = T
    XX = fp2.square(X)
    YY = fp2.square(Y)
    ZZ = fp2.square(Z)
    YZ = fp2.mul(Y, Z)

    a = fp2.mul_by_fp(fp2.mul_by_xi(fp2.dbl(fp2.mul(YZ, ZZ))), yP)
    XXX = fp2.mul(X, XX)
    b = fp2.sub(fp2.add(fp2.dbl(XXX), XXX), fp2.dbl(YY))
    t = fp2.mul_by_fp(fp2.mul(XX, ZZ), xP)
    c = fp2.neg(fp2.add(fp2.dbl(t), t))  # -3 X^2 Z^2 xP

    # dbl-2009-l reusing A = XX, B = YY
    C = fp2.square(YY)
    D = fp2.dbl(fp2.sub(fp2.sub(fp2.square(fp2.add(X, YY)), XX), C))
    E = fp2.add(fp2.dbl(XX), XX)
    F = fp2.square(E)
    X3 = fp2.sub(F, fp2.dbl(D))
    Y3 = fp2.sub(fp2.mul(E, fp2.sub(D, X3)), fp2.dbl(fp2.dbl(fp2.dbl(C))))
    Z3 = fp2.dbl(YZ)
    return (X3, Y3, Z3), _line_to_fp12(a, b, c)


def _add_step(T, Q, xP, yP):
    """Mixed-add Q (affine twist) into T and evaluate the chord line at P
    (``kzg_tpu/ops/pairing.py:85``). With n = Y - y2 Z^3, h = X - x2 Z^2,
    line scaled by -Z^3: a = XI h Z yP, b = n x2 - h Z y2, c = -n xP."""
    X, Y, Z = T
    x2, y2 = Q
    ZZ = fp2.square(Z)
    Z3 = fp2.mul(Z, ZZ)
    U2 = fp2.mul(x2, ZZ)
    S2 = fp2.mul(y2, Z3)
    h = fp2.sub(X, U2)  # -H of the usual madd convention
    n = fp2.sub(Y, S2)
    hZ = fp2.mul(h, Z)

    a = fp2.mul_by_fp(fp2.mul_by_xi(hZ), yP)
    b = fp2.sub(fp2.mul(n, x2), fp2.mul(hZ, y2))
    c = fp2.neg(fp2.mul_by_fp(n, xP))

    # madd-2007-bl with H = U2 - X = -h, r = 2 (S2 - Y) = -2 n
    H = fp2.neg(h)
    rr = fp2.neg(fp2.dbl(n))
    I = fp2.square(fp2.dbl(H))
    J = fp2.mul(H, I)
    V = fp2.mul(X, I)
    X3 = fp2.sub(fp2.sub(fp2.square(rr), J), fp2.dbl(V))
    Y3 = fp2.sub(fp2.mul(rr, fp2.sub(V, X3)), fp2.dbl(fp2.mul(Y, J)))
    Z3 = fp2.mul(fp2.dbl(H), Z)
    return (X3, Y3, Z3), _line_to_fp12(a, b, c)


def _fp12_one(xP):
    """The Fp12 one with xP's batch shape."""
    return fp12.one_like(torch.zeros((FP.L, 2, 3, 2) + tuple(xP.shape[1:]), dtype=xP.dtype,
                                     device=xP.device))


def miller_loop_plain(p_affine, q_affine):
    """conj(f_{|x|,Q}(P)) (``kzg_tpu/ops/pairing.py:117`` and ``:231``):
    p_affine (xP, yP) (12, *batch) Fp, q_affine (x2, y2) (12, 2, *batch)
    Fp2, affine Montgomery words -> (12, 2, 3, 2, *batch). Each step
    f = f^2 l_dbl, then f l_add on a set bit of |x|."""
    xP, yP = p_affine
    x2, y2 = q_affine
    T = (x2, y2, fp2.one(x2))
    f = _fp12_one(xP)
    for i in range(len(_X_BITS) - 2, -1, -1):
        f = fp12.square(f)
        T, line = _dbl_step(T, xP, yP)
        f = fp12.mul(f, line)
        if _X_BITS[i]:
            T, line = _add_step(T, (x2, y2), xP, yP)
            f = fp12.mul(f, line)
    return fp12.conj(f)  # the BLS parameter is negative


def _exp_by_z(f):
    """f^z for z = -|x| on a cyclotomic element: square-and-multiply over
    the bits of |x|, then conjugate (``kzg_tpu/ops/pairing.py:156``)."""
    acc = f
    for i in range(len(_X_BITS) - 2, -1, -1):
        acc = fp12.square(acc)
        if _X_BITS[i]:
            acc = fp12.mul(acc, f)
    return fp12.conj(acc)


def _final_exp_easy(f):
    """(p^6 - 1)(p^2 + 1): conj(f) / f, then times its p^2 power (``:176``)."""
    f = fp12.mul(fp12.conj(f), fp12.inv(f))
    return fp12.mul(fp12.frobenius(f, 2), f)


def _exp_by_e(f):
    """f^e for e = (z - 1)^2 / 3 (126 bits), square-and-multiply (``:185``)."""
    acc = f
    for i in range(len(_E_BITS) - 2, -1, -1):
        acc = fp12.square(acc)
        if _E_BITS[i]:
            acc = fp12.mul(acc, f)
    return acc


def _mul_frob1(a, b):
    return fp12.mul(a, fp12.frobenius(b, 1))  # a * b^p


def _g4_combine(g3zz, g3, f):
    g4 = fp12.mul(fp12.mul(g3zz, fp12.frobenius(g3, 2)), fp12.conj(g3))
    return fp12.mul(g4, f)


def final_exponentiation_plain(f):
    """f^((p^12 - 1) / r), canonical (``kzg_tpu/ops/pairing.py:210``):
    (12, 2, 3, 2, *batch) -> the same. Zero words map to zero."""
    f = _final_exp_easy(f)
    g2 = _exp_by_e(f)  # f^((z - 1)^2 / 3)
    g3 = _mul_frob1(_exp_by_z(g2), g2)  # ^(z + p)
    return _g4_combine(_exp_by_z(_exp_by_z(g3)), g3, f)  # ^(z^2 + p^2 - 1) * f


# ---------------------------------------------------------------------------
# K10 and K11: wrappers
# ---------------------------------------------------------------------------


def _lanes(t: torch.Tensor, lead: tuple, batch: tuple, what: str) -> torch.Tensor:
    if tuple(t.shape) != lead + batch:
        raise ValueError(f"{what} must have shape {lead + batch}, got {tuple(t.shape)}")
    return t.reshape(lead + (-1,)).contiguous()


def miller_loop(p_affine, q_affine):
    """K10 wrapper: conj(f_{|x|,Q}(P)) for affine P (xP, yP) (12, *batch)
    and Q (x2, y2) (12, 2, *batch) of one batch shape -> (12, 2, 3, 2,
    *batch). CPU tensors take ``miller_loop_plain``; CUDA tensors launch
    ``kzg_miller_loop`` (csrc/pairing.cu), one launch whatever the lane
    count."""
    xP, yP = p_affine
    x2, y2 = q_affine
    if xP.dim() < 1 or xP.shape[0] != FP.L:
        raise ValueError(f"miller_loop takes (12, *batch) Fp words, got {tuple(xP.shape)}")
    batch = tuple(xP.shape[1:])
    ops = (_lanes(xP, (FP.L,), batch, "xP"), _lanes(yP, (FP.L,), batch, "yP"),
           _lanes(x2, (FP.L, 2), batch, "x2"), _lanes(y2, (FP.L, 2), batch, "y2"))
    if all(t.device.type == "cpu" for t in ops):
        return miller_loop_plain(p_affine, q_affine)
    _build.check_cuda(*ops)
    n = ops[0].shape[1]
    out = torch.empty((FP.L, 2, 3, 2, n), dtype=torch.int32, device=xP.device)
    if n:
        _build.launch("miller_loop", "kzg_miller_loop", *(t.data_ptr() for t in ops),
                      out.data_ptr(), n)
    return out.reshape((FP.L, 2, 3, 2) + batch)


def final_exponentiation(f):
    """K11 wrapper: f^((p^12 - 1) / r) for f (12, 2, 3, 2, *batch). CPU
    tensors take ``final_exponentiation_plain``; CUDA tensors launch
    ``kzg_final_exp`` (csrc/pairing.cu), one launch, with the Frobenius
    table of ``fp12._frob_table``."""
    if f.dim() < 4 or tuple(f.shape[:4]) != (FP.L, 2, 3, 2):
        raise ValueError(f"final_exponentiation takes (12, 2, 3, 2, *batch) words, "
                         f"got {tuple(f.shape)}")
    if f.device.type == "cpu":
        return final_exponentiation_plain(f)
    flat = f.reshape(FP.L, 2, 3, 2, -1).contiguous()
    frob = fp12._frob_table(f.device)
    _build.check_cuda(flat, frob)
    n = flat.shape[-1]
    out = torch.empty_like(flat)
    if n:
        _build.launch("final_exp", "kzg_final_exp", flat.data_ptr(), frob.data_ptr(),
                      out.data_ptr(), n)
    return out.reshape(f.shape)


def _mask_trivial(out, p_inf, q_inf):
    return fp12.select(p_inf | q_inf, fp12.one_like(out), out)


def pairing(p_affine, p_inf, q_affine, q_inf):
    """Reduced optimal ate pairing, batched: K10, then K11 (their plain
    versions on a CPU tensor). ``p_inf`` / ``q_inf`` (bool, the batch
    shape) mask infinity lanes to one, as blst does."""
    out = final_exponentiation(miller_loop(p_affine, q_affine))
    return _mask_trivial(out, p_inf, q_inf)


def pairing_points(p1, p2, device):
    """e(p1, p2) for a ``curves.G1Point`` and a ``curves.G2Point`` on
    ``device`` -> the oracle's Fp12 tuple of ints (``kzg_tpu``'s format)."""
    from . import curve as cv

    x1, y1, z1 = cv.g1_to_device([p1.affine()], device)
    x2, y2, z2 = cv.g2_to_device([p2.affine()], device)
    out = pairing((x1, y1), FP.is_zero(z1), (x2, y2), fp2.is_zero(z2))
    return fp12.to_ints(out[..., 0])
