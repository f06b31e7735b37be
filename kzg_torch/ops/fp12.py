"""Fp12 = Fp6[w] / (w^2 - v) on word tensors.

Counterpart of ``kzg_tpu/ops/fp12.py``. An element is a
``(12, 2, 3, 2, *batch)`` int32 tensor: the Fp words, the Fp2 component, the
Fp6 coefficient, then the Fp12 coefficient (c0, c1), then the batch: word j
of component c of coefficient (k, h) of lane i at flat offset
``(((j * 2 + c) * 3 + k) * 2 + h) * n + i``, the layout the pairing kernels
(``csrc/pairing.cu``) read. The JAX package's nested tuples stack to this
layout in its ``verify_proofs_batch``.

``mul`` is Karatsuba over Fp6 and ``square`` the complex square, each one
``fp6.mul_many`` (one K1 launch on a CUDA tensor). The Frobenius maps
multiply every coefficient by one table of constants (``_frob_table``,
built once per device from ``hostmath._frob_tables``), which K11 reads
too. Every value is canonical, so the words are the JAX package's.
"""

from __future__ import annotations

import torch

from . import fp2, fp6
from .field import FP
from ..utils import hostmath as hm


def c0(a: torch.Tensor) -> torch.Tensor:
    return a[:, :, :, 0]


def c1(a: torch.Tensor) -> torch.Tensor:
    return a[:, :, :, 1]


def _join(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    return torch.stack([x0, x1], dim=3)



def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba over Fp6: t0 = a0 b0, t1 = a1 b1, tm = (a0 + a1)(b0 + b1);
    c0 = t0 + v t1, c1 = tm - t0 - t1. Three Fp6 products, one multiply."""
    a, b = torch.broadcast_tensors(a, b)
    sa, sb = fp6.add(c0(a), c1(a)), fp6.add(c0(b), c1(b))
    t0, t1, tm = fp6.mul_many([(c0(a), c0(b)), (c1(a), c1(b)), (sa, sb)])
    return _join(fp6.add(t0, fp6.mul_by_v(t1)), fp6.sub(tm, fp6.add(t0, t1)))


def square(a: torch.Tensor) -> torch.Tensor:
    """Complex square: t = a0 a1, s = (a0 + a1)(a0 + v a1);
    c0 = s - t - v t, c1 = 2 t. Two Fp6 products, one multiply."""
    a0, a1 = c0(a), c1(a)
    t, s = fp6.mul_many([(a0, a1), (fp6.add(a0, a1), fp6.add(a0, fp6.mul_by_v(a1)))])
    return _join(fp6.sub(fp6.sub(s, t), fp6.mul_by_v(t)), fp6.dbl(t))


def conj(a: torch.Tensor) -> torch.Tensor:
    """Conjugation = Frobenius^6 (the inverse of a cyclotomic element)."""
    return _join(c0(a), fp6.neg(c1(a)))


def inv(a: torch.Tensor) -> torch.Tensor:
    """(a0 - a1 w) / (a0^2 - v a1^2): one Fp6 inversion. Zero maps to zero."""
    a0, a1 = c0(a), c1(a)
    s0, s1 = fp6.mul_many([(a0, a0), (a1, a1)])
    f = fp6.inv(fp6.sub(s0, fp6.mul_by_v(s1)))
    r0, r1 = fp6.mul_many([(a0, f), (a1, f)])
    return _join(r0, fp6.neg(r1))


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where mask (of the batch shape), else b."""
    return torch.where(mask, a, b)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).flatten(0, 3).all(dim=0)


def one_like(a: torch.Tensor) -> torch.Tensor:
    """The Fp12 one with a's shape."""
    out = torch.zeros_like(a)
    out[:, 0, 0, 0] = FP.one_like(a[:, 0, 0, 0])
    return out


# -- host <-> device ---------------------------------------------------------


def tensor(vs, device) -> torch.Tensor:
    """Oracle Fp12 tuples ((c0, c1, c2), (c0, c1, c2)) of (x0, x1) ints ->
    (12, 2, 3, 2, n) Montgomery words on ``device``."""
    vs = list(vs)
    flat = [v[h][k][c] for c in range(2) for k in range(3) for h in range(2) for v in vs]
    return FP.tensor(flat, device).reshape(FP.L, 2, 3, 2, len(vs))


def from_ints(v, device) -> torch.Tensor:
    """One oracle Fp12 tuple -> (12, 2, 3, 2) words."""
    return tensor([v], device)[..., 0]


def to_ints_many(a: torch.Tensor) -> list:
    """(12, 2, 3, 2, *batch) words -> a list of oracle tuples, one a lane."""
    n = a[0, 0, 0, 0].numel()
    ints = FP.from_words_many(a.reshape(FP.L, 12 * n))
    col = lambda c, k, h, i: ints[((c * 3 + k) * 2 + h) * n + i]  # noqa: E731
    return [tuple(tuple((col(0, k, h, i), col(1, k, h, i)) for k in range(3)) for h in range(2))
            for i in range(n)]


def to_ints(a: torch.Tensor):
    """(12, 2, 3, 2) words -> the oracle's tuple (``kzg_tpu``'s format)."""
    return to_ints_many(a.reshape(a.shape[:4] + (1,)))[0]


# -- Frobenius -----------------------------------------------------------------

_frob: dict = {}


def _frob_table(device) -> torch.Tensor:
    """(12, 2, 3, 2, 3) words: for k = 1, 2, 3 (last axis), coefficient
    (kk, h)'s constant of a^(p^k): XI^(kk (p^k - 1) / 3 + h (p^k - 1) / 6),
    the product of the Fp6 and Fp12 constants of ``hostmath._frob_tables``
    that the JAX package applies one after the other (1 at (0, 0))."""
    key = str(device)
    if key not in _frob:
        f6, f12 = hm._frob_tables()
        gammas = []
        for k in (1, 2, 3):
            g6 = [hm.FP2_ONE] + f6[k]
            gammas.append(tuple(tuple(hm.fp2_mul(g6[kk], f12[k]) if h else g6[kk]
                                      for kk in range(3)) for h in range(2)))
        _frob[key] = tensor(gammas, device)
    return _frob[key]


def frobenius(a: torch.Tensor, k: int) -> torch.Tensor:
    """a^(p^k), k in 1..3: each Fp2 coefficient conjugated if k is odd, then
    times its constant (one stacked Fp2 multiply)."""
    g = _frob_table(a.device)[..., k - 1]
    g = g.reshape(g.shape + (1,) * (a.dim() - g.dim()))
    return fp2.mul(fp2.conj(a) if k % 2 else a, g)


# -- constant-exponent power ---------------------------------------------------


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a python-int exponent: square-and-multiply, LSB first."""
    acc = one_like(a)
    base = a
    while e:
        if e & 1:
            acc = mul(acc, base)
        e >>= 1
        if e:
            base = square(base)
    return acc
