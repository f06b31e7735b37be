"""Polynomial operations over Fr: powers, evaluation, synthetic division.

Counterpart of ``kzg_tpu/ops/poly.py:26-102``. The JAX package computes
these as ``lax.associative_scan``s; here the scans are plain PyTorch
pair-up recursions (``Field._prefix_prod`` and ``_affine_scan`` below) over
Fr multiplies, which are kernel K1 on a CUDA tensor. Every Fr value is
canonical, so any association of the products gives the same words as the
JAX package's.

All tensors are (8, n) Montgomery Fr words unless noted; a point x or a root
is (8,) words.
"""

from __future__ import annotations

import torch

from .field import FR


def powers(x: torch.Tensor, n: int) -> torch.Tensor:
    """[1, x, x^2, ..., x^(n-1)] as (8, n) Montgomery words."""
    one = FR.const("ONE", x.device)
    if n <= 0:
        return torch.zeros(FR.L, 0, dtype=torch.int32, device=x.device)
    elems = torch.cat([one, x.reshape(FR.L, 1).expand(FR.L, n - 1)], dim=1)
    return FR._prefix_prod(elems)


def power_sequence(s: torch.Tensor, n: int) -> torch.Tensor:
    """[s^0, ..., s^(n-1)]: the trusted-setup power ladder."""
    return powers(s, n)


def tree_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum (8, N) Fr elements along the batch axis in log2(N) batched adds,
    halving as the JAX package does (an odd tail is carried up)."""
    n = terms.shape[1]
    if n == 0:
        return torch.zeros(FR.L, dtype=torch.int32, device=terms.device)
    while n > 1:
        half = n // 2
        s = FR.add(terms[:, :half], terms[:, half : 2 * half])
        terms = torch.cat([s, terms[:, 2 * half :]], dim=1) if n % 2 else s
        n = terms.shape[1]
    return terms[:, 0]


def evaluate(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """P(x) = sum_i coeffs[:, i] x^i: powers, one batched multiply, a tree
    sum. coeffs (8, n), x (8,) -> (8,)."""
    n = coeffs.shape[1]
    if n == 0:
        return torch.zeros(FR.L, dtype=torch.int32, device=coeffs.device)
    return tree_sum(FR.mul(coeffs, powers(x, n)))


def _compose(first, then):
    """The affine map x -> a x + b that applies ``first``, then ``then``:
    (a1, b1) then (a2, b2) is (a2 a1, a2 b1 + b2)."""
    a1, b1 = first
    a2, b2 = then
    return FR.mul(a1, a2), FR.add(FR.mul(b1, a2), b2)


def _affine_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of affine maps along the last axis of (8, n): element i
    of the result composes maps 0..i. Pair up, recurse on the n/2 pair
    composites, expand (the shape of ``Field._prefix_prod``)."""
    n = a.shape[1]
    if n == 1:
        return a, b
    if n % 2:
        a = torch.cat([a, FR.const("ONE", a.device)], dim=1)
        b = torch.cat([b, torch.zeros_like(b[:, :1])], dim=1)
    ev, od = (a[:, 0::2], b[:, 0::2]), (a[:, 1::2], b[:, 1::2])
    pa, pb = _affine_scan(*_compose(ev, od))  # composite of maps 0 .. 2i + 1
    oa, ob = torch.empty_like(a), torch.empty_like(b)
    oa[:, 1::2], ob[:, 1::2] = pa, pb
    oa[:, 0], ob[:, 0] = a[:, 0], b[:, 0]
    oa[:, 2::2], ob[:, 2::2] = _compose((pa[:, :-1], pb[:, :-1]), (ev[0][:, 1:], ev[1][:, 1:]))
    return oa[:, :n], ob[:, :n]


def synthetic_divide(coeffs: torch.Tensor, root: torch.Tensor):
    """Divide P (coeffs (8, n), ascending, n >= 2) by (x - root).

    Returns (quotient (8, n - 1) ascending, rebuilt_constant (8,)), where
    rebuilt_constant = -root q_0 equals coeffs[:, 0] exactly when root is a
    root (the reference's constant-term check, src/polynomial.rs:183-192).

    The recurrence u_k = root u_{k-1} + b_k over the reversed high
    coefficients b_k = p_{n-1-k} is a scan of the maps x -> root x + b_k,
    the first of them the constant map x -> b_0."""
    n = coeffs.shape[1]
    if n < 2:
        raise ValueError("synthetic_divide needs at least two coefficients")
    b = coeffs.flip(1)[:, : n - 1].contiguous()
    a = root.reshape(FR.L, 1).repeat(1, n - 1)  # a copy: a[:, 0] is written
    a[:, 0] = 0
    _, u = _affine_scan(a, b)
    quotient = u.flip(1).contiguous()
    rebuilt = FR.neg(FR.mul(root.reshape(FR.L, 1), quotient[:, :1]))
    return quotient, rebuilt[:, 0]
