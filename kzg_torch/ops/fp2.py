"""Fp2 = Fp[u] / (u^2 + 1) on word tensors.

Counterpart of ``kzg_tpu/ops/fp2.py``. An element is a ``(12, 2, *batch)``
int32 tensor: the Fp words first, then the (c0, c1) component axis, then the
batch, as the JAX package's ``(24, 2, *batch)`` is for 16-bit limbs. The
linear operations are ``FP``'s (they broadcast over every trailing axis);
``mul`` is Karatsuba as one stacked ``FP.mul`` of three products, ``square``
the complex square as one of two, so on a CUDA tensor each is one launch of
K1. Every value is canonical, so the words equal the JAX package's.

The G2 point formulas (``curve.g2_*``) run on these operations in their
plain versions and on the same arithmetic in ``csrc/g2.cuh`` in K9; so do
the Fp6 / Fp12 towers (``fp6.py``, ``fp12.py``), whose coefficient axes
follow the component axis, and the pairing's plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import FP

add = FP.add
sub = FP.sub
neg = FP.neg
dbl = FP.dbl


def tensor(cs, device) -> torch.Tensor:
    """Iterable of (c0, c1) ints -> (12, 2, n) Montgomery words on ``device``."""
    cs = list(cs)
    words = np.stack([FP.many_to_words([c[0] for c in cs]),
                      FP.many_to_words([c[1] for c in cs])], axis=1)
    return torch.from_numpy(words).to(device)


def to_ints(a) -> list:
    """(12, 2, *batch) words -> flat list of (c0, c1) ints."""
    return list(zip(FP.from_words_many(a[:, 0]), FP.from_words_many(a[:, 1])))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba: v0 = a0 b0, v1 = a1 b1, v2 = (a0 + a1)(b0 + b1);
    c0 = v0 - v1, c1 = v2 - (v0 + v1)."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, b0, b1 = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    p = FP.mul(torch.stack([a0, a1, FP.add(a0, a1)], dim=1),
               torch.stack([b0, b1, FP.add(b0, b1)], dim=1))
    v0, v1, v2 = p[:, 0], p[:, 1], p[:, 2]
    return torch.stack([FP.sub(v0, v1), FP.sub(v2, FP.add(v0, v1))], dim=1)


def square(a: torch.Tensor) -> torch.Tensor:
    """Complex square: c0 = (a0 + a1)(a0 - a1), c1 = 2 a0 a1."""
    a0, a1 = a[:, 0], a[:, 1]
    return FP.mul(torch.stack([FP.add(a0, a1), FP.dbl(a0)], dim=1),
                  torch.stack([FP.sub(a0, a1), a1], dim=1))


def mul_by_fp(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Both components times an Fp element k (12, *batch)."""
    return FP.mul(a, k.unsqueeze(1))


def conj(a: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[:, 0], FP.neg(a[:, 1])], dim=1)


def mul_by_xi(a: torch.Tensor) -> torch.Tensor:
    """Times the sextic non-residue XI = 1 + u: (c0 - c1, c0 + c1)."""
    a0, a1 = a[:, 0], a[:, 1]
    return torch.stack([FP.sub(a0, a1), FP.add(a0, a1)], dim=1)


def inv(a: torch.Tensor) -> torch.Tensor:
    """1 / (a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2): the norm, then one
    batched Fp inversion over every lane (K1i on a CUDA tensor; the inverse
    is unique, so the words are the JAX package's per-lane Fermat ladder's).
    Zero maps to zero."""
    a0, a1 = a[:, 0], a[:, 1]
    p = FP.mul(a, a)
    norm = FP.add(p[:, 0], p[:, 1])
    ninv = FP.inv_batch(norm.reshape(FP.L, -1)).reshape(norm.shape)
    return torch.stack([FP.mul(a0, ninv), FP.neg(FP.mul(a1, ninv))], dim=1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=1).all(dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=1).all(dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where mask (of the batch shape), else b."""
    return torch.where(mask, a, b)


def one(ref: torch.Tensor) -> torch.Tensor:
    """The Montgomery one (1, 0) with ref's shape."""
    c0 = FP.one_like(ref[:, 0])
    return torch.stack([c0, torch.zeros_like(c0)], dim=1)


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a python-int exponent: square-and-multiply, LSB first."""
    acc = one(a)
    base = a
    while e:
        if e & 1:
            acc = mul(acc, base)
        e >>= 1
        if e:
            base = square(base)
    return acc
