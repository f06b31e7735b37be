"""Fp6 = Fp2[v] / (v^3 - XI), XI = 1 + u, on word tensors.

Counterpart of ``kzg_tpu/ops/fp6.py``. An element is a ``(12, 2, 3, *batch)``
int32 tensor: the Fp words, the Fp2 component axis, then the three Fp2
coefficients (c0, c1, c2), then the batch. The JAX package keeps a tuple of
three Fp2 arrays; here the coefficient axis lets ``fp2``'s and ``FP``'s
operations broadcast over all three at once, so an add is one ``FP.add``.

``mul`` is the Toom / Karatsuba form of six Fp2 products, stacked into one
``fp2.mul`` (one K1 launch on a CUDA tensor), ``mul_many`` K such products
into one. Every value is canonical, so however the adds are grouped the
words are the JAX package's.
"""

from __future__ import annotations

import torch

from . import fp2
from .field import FP

add = FP.add
sub = FP.sub
neg = FP.neg
dbl = FP.dbl


def coeffs(a: torch.Tensor):
    """The three Fp2 coefficients (12, 2, *batch) of a."""
    return a[:, :, 0], a[:, :, 1], a[:, :, 2]


def _mul_operands(a: torch.Tensor) -> torch.Tensor:
    """The six Toom operand slots [a0, a1, a2, a1 + a2, a0 + a1, a0 + a2]
    on the coefficient axis, the sums as one add."""
    sums = FP.add(a[:, :, [1, 0, 0]], a[:, :, [2, 1, 2]])
    return torch.cat([a, sums], dim=2)


def _mul_combine(p: torch.Tensor) -> torch.Tensor:
    """The six products [t0, t1, t2, m12, m01, m02] (coefficient axis) ->
    c0 = t0 + XI (m12 - t1 - t2), c1 = m01 - t0 - t1 + XI t2,
    c2 = m02 - t0 - t2 + t1."""
    t0, t1, t2 = p[:, :, 0], p[:, :, 1], p[:, :, 2]
    d = FP.sub(p[:, :, 3:6], FP.add(p[:, :, [1, 0, 0]], p[:, :, [2, 1, 2]]))
    x = fp2.mul_by_xi(torch.stack([d[:, :, 0], t2], dim=2))
    return FP.add(torch.stack([t0, d[:, :, 1], d[:, :, 2]], dim=2),
                  torch.stack([x[:, :, 0], x[:, :, 1], t1], dim=2))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Six Fp2 products, one stacked Fp2 multiply."""
    a, b = torch.broadcast_tensors(a, b)
    return _mul_combine(fp2.mul(_mul_operands(a), _mul_operands(b)))


def mul_many(pairs) -> list:
    """K independent Fp6 products in one stacked Fp2 multiply (6K products,
    one K1 launch on a CUDA tensor). pairs: [(a, b), ...] of one shape."""
    lhs = torch.cat([_mul_operands(a) for a, _ in pairs], dim=2)
    rhs = torch.cat([_mul_operands(b) for _, b in pairs], dim=2)
    p = fp2.mul(lhs, rhs)
    return [_mul_combine(p[:, :, 6 * i : 6 * i + 6]) for i in range(len(pairs))]


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_by_v(a: torch.Tensor) -> torch.Tensor:
    """(c0, c1, c2) -> (XI c2, c0, c1)."""
    return torch.stack([fp2.mul_by_xi(a[:, :, 2]), a[:, :, 0], a[:, :, 1]], dim=2)


def mul_by_fp2(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """All three coefficients times one Fp2 element k (12, 2, *batch)."""
    return fp2.mul(a, k.unsqueeze(2))


def inv(a: torch.Tensor) -> torch.Tensor:
    """kzg_tpu's formula: the norm to Fp2, one Fp2 inversion (``fp2.inv``:
    one batched Fp inversion over every lane), three products. Zero maps to
    zero."""
    a0, a1, a2 = coeffs(a)
    xi = fp2.mul_by_xi
    t0 = fp2.sub(fp2.square(a0), xi(fp2.mul(a1, a2)))
    t1 = fp2.sub(xi(fp2.square(a2)), fp2.mul(a0, a1))
    t2 = fp2.sub(fp2.square(a1), fp2.mul(a0, a2))
    denom = fp2.add(fp2.mul(a0, t0), xi(fp2.add(fp2.mul(a2, t1), fp2.mul(a1, t2))))
    return mul_by_fp2(torch.stack([t0, t1, t2], dim=2), fp2.inv(denom))


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where mask (of the batch shape), else b."""
    return torch.where(mask, a, b)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).flatten(0, 2).all(dim=0)
