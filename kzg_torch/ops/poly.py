"""Polynomial operations over Fr: powers, evaluation, synthetic division.

Counterpart of ``kzg_tpu/ops/poly.py:26-102``. The JAX package computes
these as ``lax.associative_scan``s. Here:

- ``powers`` (the ceremony's power ladder) is a plain PyTorch pair-up
  recursion (``Field._prefix_prod``) over Fr multiplies, which are kernel K1
  on a CUDA tensor;
- ``evaluate`` and ``synthetic_divide`` (the opening proof's two scans) are
  the hand-written kernels K1e and K1d on a CUDA tensor
  (``csrc/fr_poly.cu``: two and three launches whatever n), and the pair-up
  recursions ``evaluate_plain`` and ``synthetic_divide_plain`` on a CPU
  tensor;
- ``evaluate_runs_plain`` and ``synthetic_divide_runs_plain`` compute the
  same in the kernels' decomposition (runs, blocks, tiles, carries), with the
  run and the block as parameters, so that the CPU tests reach its
  boundaries at small sizes.

Every Fr value is canonical, so any association of the sums and products
gives the same words as the JAX package's.

All tensors are (8, n) Montgomery Fr words unless noted; a point x or a root
is (8,) words.
"""

from __future__ import annotations

import torch

from . import _build
from .field import FR

POLY_BLOCK = 128  # threads a block of the fr_poly.cu kernels (kPolyBlock there)
POLY_RUN = 8  # lanes a thread of the first pass takes in turn (kPolyRun there)


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


def _check(name: str, coeffs: torch.Tensor, point: torch.Tensor) -> None:
    if coeffs.dim() != 2 or coeffs.shape[0] != FR.L or point.shape != (FR.L,):
        raise ValueError(f"{name} takes ({FR.L}, n) coefficients and an ({FR.L},) point, got "
                         f"{tuple(coeffs.shape)} and {tuple(point.shape)}")
    if coeffs.dtype != torch.int32 or point.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 words")
    if coeffs.shape[1] >= 1 << 31:
        raise ValueError(f"{name} takes fewer than 2^31 coefficients")


def _tiles(n: int) -> int:
    return -(-n // (POLY_BLOCK * POLY_RUN))


# ---------------------------------------------------------------------------
# K1e: evaluation
# ---------------------------------------------------------------------------


def evaluate(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """P(x) = sum_i coeffs[:, i] x^i. coeffs (8, n), x (8,) -> (8,).

    CPU tensors take ``evaluate_plain``; CUDA tensors launch ``kzg_fr_eval``
    twice (csrc/fr_poly.cu): the tiles' values, then those values at
    x^(POLY_BLOCK POLY_RUN) in one block."""
    _check("evaluate", coeffs, x)
    n = coeffs.shape[1]
    if n == 0:
        return torch.zeros(FR.L, dtype=torch.int32, device=coeffs.device)
    if coeffs.device.type == "cpu":
        return evaluate_plain(coeffs, x)
    coeffs, x = coeffs.contiguous(), x.contiguous()
    _build.check_cuda(coeffs, x)
    g = _tiles(n)
    vals = torch.empty(FR.L, g, dtype=torch.int32, device=x.device)
    y, out = torch.empty_like(x), torch.empty_like(x)
    _build.launch("fr_evaluate", "kzg_fr_eval", coeffs.data_ptr(), n, n, POLY_RUN, x.data_ptr(),
                  vals.data_ptr(), g, y.data_ptr())
    _build.launch("fr_evaluate", "kzg_fr_eval", vals.data_ptr(), g, g, -(-g // POLY_BLOCK),
                  y.data_ptr(), out.data_ptr(), 1, None)
    return out


def evaluate_plain(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1e: powers, one batched multiply, a tree sum."""
    n = coeffs.shape[1]
    if n == 0:
        return torch.zeros(FR.L, dtype=torch.int32, device=coeffs.device)
    return tree_sum(FR.mul(coeffs, powers(x, n)))


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """FR.mul with b (8, ...) lifted to a's rank."""
    return FR.mul(a, b.reshape(b.shape + (1,) * (a.dim() - b.dim())))


def _horner(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_k c[..., k] x^k over the last axis of (8, ..., m), m >= 1, top
    down; x is (8,) or of c's shape without the last axis."""
    acc = c[..., -1]
    for k in range(c.shape[-1] - 2, -1, -1):
        acc = FR.add(c[..., k], _mul(acc, x))
    return acc


def _tile_values(c: torch.Tensor, x: torch.Tensor, run: int, block: int) -> torch.Tensor:
    """(8, g): tile b's value sum_e c[:, b T + e] x^e over T = run block
    lanes, lanes past n as zero. As ``fr_eval_kernel``: thread t runs Horner
    in x^block over the lanes b T + t + k block, then a tree over the
    block's threads, lo + x^w hi (block a power of two)."""
    n = c.shape[1]
    T = run * block
    g = -(-n // T)
    c = torch.nn.functional.pad(c, (0, g * T - n)).reshape(FR.L, g, run, block)
    xp = [x]
    while len(xp) <= block.bit_length() - 1:
        xp.append(FR.mul(xp[-1], xp[-1]))  # x^(2^l)
    acc = _horner(c.transpose(2, 3), xp[-1])  # (8, g, block)
    for p in xp[:-1]:
        acc = FR.add(acc[..., 0::2], _mul(acc[..., 1::2], p))
    return acc[..., 0]


def evaluate_runs_plain(coeffs: torch.Tensor, x: torch.Tensor, run: int = POLY_RUN,
                        block: int = POLY_BLOCK) -> torch.Tensor:
    """P(x) in K1e's decomposition: the tiles' values, then those values at
    y = x^(run block) as one tile of runs of ceil(g / block)."""
    n = coeffs.shape[1]
    if n == 0:
        return torch.zeros(FR.L, dtype=torch.int32, device=coeffs.device)
    vals = _tile_values(coeffs, x, run, block)
    g = vals.shape[1]
    return _tile_values(vals, FR.pow_const(x, run * block), -(-g // block), block)[:, 0]


# ---------------------------------------------------------------------------
# K1d: synthetic division
# ---------------------------------------------------------------------------


def synthetic_divide(coeffs: torch.Tensor, root: torch.Tensor):
    """Divide P (coeffs (8, n), ascending, n >= 2) by (x - root).

    Returns (quotient (8, n - 1) ascending, rebuilt_constant (8,)), where
    rebuilt_constant = -root q_0 equals coeffs[:, 0] exactly when root is a
    root (the reference's constant-term check, src/polynomial.rs:183-192).

    CPU tensors take ``synthetic_divide_plain``; CUDA tensors launch
    ``kzg_fr_eval`` (the tiles' totals), ``kzg_fr_div_top`` (their carries)
    and ``kzg_fr_div_down`` (the quotient and the rebuilt constant),
    csrc/fr_poly.cu."""
    _check("synthetic_divide", coeffs, root)
    n = coeffs.shape[1]
    if n < 2:
        raise ValueError("synthetic_divide needs at least two coefficients")
    if coeffs.device.type == "cpu":
        return synthetic_divide_plain(coeffs, root)
    coeffs, root = coeffs.contiguous(), root.contiguous()
    _build.check_cuda(coeffs, root)
    g = _tiles(n - 1)
    tot = torch.empty(FR.L, g, dtype=torch.int32, device=root.device)
    carry = torch.empty_like(tot)
    y, rebuilt = torch.empty_like(root), torch.empty_like(root)
    quotient = torch.empty(FR.L, n - 1, dtype=torch.int32, device=root.device)
    # c = coeffs[:, 1:]: the same rows, one word further on
    _build.launch("fr_divide", "kzg_fr_eval", coeffs.data_ptr() + 4, n, n - 1, POLY_RUN,
                  root.data_ptr(), tot.data_ptr(), g, y.data_ptr())
    _build.launch("fr_divide", "kzg_fr_div_top", tot.data_ptr(), g, y.data_ptr(),
                  carry.data_ptr())
    _build.launch("fr_divide", "kzg_fr_div_down", coeffs.data_ptr(), n, root.data_ptr(),
                  carry.data_ptr(), g, quotient.data_ptr(), rebuilt.data_ptr())
    return quotient, rebuilt


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


def synthetic_divide_plain(coeffs: torch.Tensor, root: torch.Tensor):
    """Plain version of K1d. The recurrence u_k = root u_{k-1} + b_k over the
    reversed high coefficients b_k = p_{n-1-k} is a scan of the maps
    x -> root x + b_k, the first of them the constant map x -> b_0."""
    n = coeffs.shape[1]
    if n < 2:
        raise ValueError("synthetic_divide needs at least two coefficients")
    b = coeffs.flip(1)[:, : n - 1].contiguous()
    a = root.reshape(FR.L, 1).repeat(1, n - 1)  # a copy: a[:, 0] is written
    a[:, 0] = 0
    _, u = _affine_scan(a, b)
    quotient = u.flip(1).contiguous()
    return quotient, _rebuilt(root, quotient)


def _rebuilt(root: torch.Tensor, quotient: torch.Tensor) -> torch.Tensor:
    return FR.neg(FR.mul(root.reshape(FR.L, 1), quotient[:, :1]))[:, 0]


def _suffix_runs(c: torch.Tensor, r: torch.Tensor, cin: torch.Tensor) -> torch.Tensor:
    """q = c + r q', the suffix scan along the runs of c (8, G, block, run)
    (run-major: position t run + k of each of the G groups), with cin (8, G)
    carried into each group's end. As ``fr_div_down_kernel``: each run's
    total, a Hillis-Steele suffix scan of the totals with r^run (cin folded
    into the last), then each run again from its carry."""
    run, block = c.shape[3], c.shape[2]
    m = FR.pow_const(r, run)
    s = _horner(c, r)  # (8, G, block)
    s = torch.cat([s[..., :-1], FR.add(s[..., -1:], _mul(cin[..., None], m))], -1)
    shift = 1
    while shift < block:
        s = torch.cat([FR.add(s[..., :-shift], _mul(s[..., shift:], m)), s[..., -shift:]], -1)
        m = FR.mul(m, m)
        shift *= 2
    q = torch.empty_like(c)
    cur = torch.cat([s[..., 1:], cin[..., None]], -1)  # the carry into each run's top
    for k in range(run - 1, -1, -1):
        cur = FR.add(c[..., k], _mul(cur, r))
        q[..., k] = cur
    return q


def synthetic_divide_runs_plain(coeffs: torch.Tensor, root: torch.Tensor, run: int = POLY_RUN,
                                block: int = POLY_BLOCK):
    """synthetic_divide in K1d's decomposition over c = coeffs[:, 1:]: the
    tiles' totals (``_tile_values``), their carries (one group of block runs
    of ceil(g / block) tiles, exclusive), then each tile of block runs of
    ``run`` from its carry."""
    n = coeffs.shape[1]
    if n < 2:
        raise ValueError("synthetic_divide needs at least two coefficients")
    d, T = n - 1, run * block
    c = coeffs[:, 1:]
    tot = _tile_values(c, root, run, block)
    g = tot.shape[1]
    rho = -(-g // block)
    top = torch.nn.functional.pad(tot, (0, rho * block - g)).reshape(FR.L, 1, block, rho)
    zero = torch.zeros(FR.L, 1, dtype=torch.int32, device=root.device)
    at_tile = _suffix_runs(top, FR.pow_const(root, T), zero).reshape(FR.L, -1)
    carry = torch.cat([at_tile[:, 1:g], zero], 1)  # q at the first position of tile b + 1
    tiles = torch.nn.functional.pad(c, (0, g * T - d)).reshape(FR.L, g, block, run)
    quotient = _suffix_runs(tiles, root, carry).reshape(FR.L, g * T)[:, :d].contiguous()
    return quotient, _rebuilt(root, quotient)
