"""Montgomery prime-field arithmetic on limb-major int32 word tensors.

Counterpart of ``kzg_tpu/ops/field.py``. A ``Field`` holds the constants of
one modulus and exposes batched, branchless operations on ``(L32, *batch)``
int32 tensors of canonical Montgomery words (``ops/limbs.py``), R = 2^(32 L32)
(2^384 for Fp, 2^256 for Fr, as in the JAX package).

The multiply is kernel K1 (``csrc/mont_mul.cu``) on a CUDA tensor and its
plain version, ``mont_mul_plain``, on a CPU tensor. The batched inversion is
one hand-written kernel too (``csrc/inv_batch.cu``, three launches) on a
CUDA tensor, and ``Field.inv_batch_plain`` on a CPU tensor. The other
operations (add, sub, neg, selects, the single-value ladders) are plain
PyTorch on either device, as they were XLA outside Pallas in the JAX
package: they widen the words to 16-bit limbs in int64, where a carry chain
is a few shifts.
"""

from __future__ import annotations

import torch

from . import _build
from . import limbs as lb
from ..utils import hostmath as hm


class Field:
    def __init__(self, modulus: int, n_words: int, name: str, kernel_id: int):
        self.name = name
        self.modulus = modulus
        self.L = n_words  # 32-bit words
        self.L16 = 2 * n_words
        self.R_int = 1 << (32 * n_words)
        self.R2_int = self.R_int * self.R_int % modulus
        self.n_prime_int = (-pow(modulus, -1, self.R_int)) % self.R_int
        self.kernel_id = kernel_id  # the field argument of kzg_mont_mul
        self._consts: dict = {}

    # -- host conversions ---------------------------------------------------

    def many_to_words(self, values):
        """Ints -> (L, n) int32 Montgomery words (numpy)."""
        m = self.modulus
        return lb.ints_to_words([v % m * self.R_int % m for v in values], self.L)

    def many_to_words_std(self, values):
        """Ints -> (L, n) int32 standard-form words (numpy)."""
        return lb.ints_to_words([v % self.modulus for v in values], self.L)

    def from_words_many(self, words) -> list[int]:
        rinv = pow(self.R_int, -1, self.modulus)
        return [v * rinv % self.modulus for v in lb.words_to_ints(words)]

    def tensor(self, values, device, mont: bool = True) -> torch.Tensor:
        """Ints -> (L, n) int32 tensor on ``device``."""
        arr = self.many_to_words(values) if mont else self.many_to_words_std(values)
        return torch.from_numpy(arr).to(device)

    def const(self, name: str, device) -> torch.Tensor:
        """(L, 1) word constant: "N", "ONE" (Montgomery one), "R2", "ONE_STD",
        "NEG_N" (2^(32 L) - N)."""
        key = (name, str(device))
        if key not in self._consts:
            value = {"N": self.modulus, "ONE": self.R_int % self.modulus,
                     "R2": self.R2_int, "ONE_STD": 1, "NEG_N": self.R_int - self.modulus}[name]
            self._consts[key] = torch.from_numpy(lb.ints_to_words([value], self.L)).to(device)
        return self._consts[key]

    def const16(self, name: str, device) -> torch.Tensor:
        """(L16, 1) int64 16-bit limb constant, or a Toeplitz matrix for
        "T_NPRIME" ((L16, L16), low product by N') and "T_N" ((2 L16, L16))."""
        key = (name + "16", str(device))
        if key not in self._consts:
            if name in ("T_NPRIME", "T_N"):
                value = self.n_prime_int if name == "T_NPRIME" else self.modulus
                rows = self.L16 if name == "T_NPRIME" else 2 * self.L16
                digits = [(value >> (16 * i)) & lb.MASK16 for i in range(self.L16)]
                t = torch.zeros(rows, self.L16, dtype=torch.float64)
                for i in range(rows):
                    for j in range(max(0, i - self.L16 + 1), min(i + 1, self.L16)):
                        t[i, j] = digits[i - j]
                self._consts[key] = t.to(device)
            else:
                self._consts[key] = lb.words_to_limbs16(self.const(name, "cpu")).to(device)
        return self._consts[key]

    # -- plain 16-bit-limb arithmetic (int64, any device) --------------------

    def _cond_sub16(self, s: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
        """s + carry * 2^(16 L16) < 2N -> canonical: add 2^(16 L16) - N, whose
        carry out says s >= N."""
        nc = _lift(self.const16("NEG_N", s.device), s)
        d, ge = lb.normalize(s + nc, passes=1)
        return torch.where(((carry > 0) | (ge > 0)).unsqueeze(0), d, s)

    def add16(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s, carry = lb.normalize(a + b, passes=1)
        return self._cond_sub16(s, carry)

    def sub16(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a + (2^(16 L16) - 1 - b) + 1: a carry out means no borrow; on a
        borrow add N back."""
        one0 = _lift(self.const16("ONE_STD", a.device), a)
        d, no_borrow = lb.normalize(a + (lb.MASK16 - b) + one0, passes=1)
        dn, _ = lb.normalize(d + _lift(self.const16("N", a.device), d), passes=1)
        return torch.where((no_borrow == 0).unsqueeze(0), dn, d)

    def mul16(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product on 16-bit limbs: schoolbook columns, then one
        full-width REDC t + m N with m = t N' mod R, whose constant products
        are exact float64 matmuls (every column is below 2^37 < 2^53).

        Only the final sum is fully carry-normalized: t and m need limbs of
        at most 2^16 for the matmuls to stay exact, and m may then exceed R
        by a hair (m = t N' mod R up to a multiple of R dropped with the top
        carries), which keeps (t + m N) / R < 2N because N < R / 2."""
        L = self.L16
        a, b = torch.broadcast_tensors(a, b)
        batch = a.shape[1:]
        a2 = a.reshape(L, -1)
        b2 = b.reshape(L, -1)
        cols = torch.zeros(2 * L, a2.shape[1], dtype=torch.int64, device=a.device)
        for i in range(L):
            cols[i : i + L] += a2[i] * b2
        t, _ = lb.local_passes(cols, 3)
        m = torch.matmul(self.const16("T_NPRIME", a.device), t[:L].to(torch.float64))
        m, _ = lb.local_passes(m.to(torch.int64), 3)
        u = torch.matmul(self.const16("T_N", a.device), m.to(torch.float64)).to(torch.int64)
        s, carry = lb.normalize(t + u)
        return self._cond_sub16(s[L:], carry).reshape((L,) + batch)

    # -- operations on word tensors -------------------------------------------

    def _via16(self, fn, *args):
        return lb.limbs16_to_words(fn(*(lb.words_to_limbs16(a) for a in args)))

    def add(self, a, b):
        return self._via16(self.add16, a, b)

    def sub(self, a, b):
        return self._via16(self.sub16, a, b)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def dbl(self, a):
        return self.add(a, a)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product: K1 on a CUDA tensor, the plain version on a
        CPU tensor. Batch shapes broadcast."""
        a, b = torch.broadcast_tensors(a, b)
        if a.device.type == "cpu":
            return mont_mul_plain(a, b, self)
        return mont_mul(a.contiguous(), b.contiguous(), self)

    def square(self, a):
        return self.mul(a, a)

    def to_mont(self, a):
        """Standard-form words -> Montgomery form."""
        return self.mul(a, _lift(self.const("R2", a.device), a))

    def from_mont(self, a):
        """Montgomery form -> canonical standard-form words (a * 1 * R^-1)."""
        return self.mul(a, _lift(self.const("ONE_STD", a.device), a))

    def one_like(self, a):
        return _lift(self.const("ONE", a.device), a).expand_as(a).contiguous()

    @staticmethod
    def is_zero(a):
        return (a == 0).all(dim=0)

    @staticmethod
    def select(mask, a, b):
        return torch.where(mask.unsqueeze(0), a, b)

    def pow_const(self, a, e: int):
        """a^e for a python-int exponent: square-and-multiply, LSB first."""
        acc = self.one_like(a)
        base = a
        while e:
            if e & 1:
                acc = self.mul(acc, base)
            e >>= 1
            if e:
                base = self.square(base)
        return acc

    def inv(self, a):
        """Fermat inverse a^(N-2); inv(0) = 0."""
        return self.pow_const(a, self.modulus - 2)

    def inv_batch(self, a):
        """The inverse of every lane of a (L, *batch), zero lanes mapped to
        zero: the kernel on a CUDA tensor, the plain version on a CPU tensor
        (``inv_batch`` below)."""
        return inv_batch(a, self)

    def inv_batch_plain(self, a):
        """Montgomery-trick inversion over every lane of a: inv(a_i) =
        prefix_{i-1} * suffix_{i+1} * inv(prefix_{n-1}), two work-efficient
        product scans and ONE Fermat inversion. Zero lanes map to zero."""
        shape = a.shape
        flat = a.reshape(self.L, -1)
        zero = self.is_zero(flat)
        safe = self.select(zero, self.one_like(flat), flat)
        pre = self._prefix_prod(safe)
        suf = self._prefix_prod(safe.flip(-1)).flip(-1)
        total_inv = self.inv(pre[:, -1:])
        one = self.const("ONE", a.device)
        pre_shift = torch.cat([one, pre[:, :-1]], dim=1)
        suf_shift = torch.cat([suf[:, 1:], one], dim=1)
        out = self.mul(self.mul(pre_shift, suf_shift), total_inv)
        return self.select(zero, torch.zeros_like(out), out).reshape(shape)

    def _prefix_prod(self, a):
        """Inclusive prefix products along the last axis of (L, n):
        pair up, recurse on the n/2 pair products, expand (2n multiplies)."""
        n = a.shape[1]
        if n == 1:
            return a
        if n % 2:
            a = torch.cat([a, self.const("ONE", a.device)], dim=1)
        even, odd = a[:, 0::2], a[:, 1::2]
        pp = self._prefix_prod(self.mul(even, odd))  # pp[i] = a_0 ... a_{2i+1}
        out = torch.empty_like(a)
        out[:, 1::2] = pp
        out[:, 0] = a[:, 0]
        out[:, 2::2] = self.mul(pp[:, :-1], even[:, 1:])
        return out[:, :n]


def _lift(c: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(L, 1) constant -> (L, 1, ..., 1) matching ref's rank."""
    return c.reshape((c.shape[0],) + (1,) * (ref.dim() - 1))


# ---------------------------------------------------------------------------
# K1: the Montgomery multiply
# ---------------------------------------------------------------------------


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, field: Field) -> torch.Tensor:
    """Plain PyTorch version of K1 (any device): a * b * R^-1 mod N."""
    return field._via16(field.mul16, a, b)


def mont_mul(a: torch.Tensor, b: torch.Tensor, field: Field) -> torch.Tensor:
    """K1 wrapper: a, b (L, *batch) int32 canonical Montgomery words of one
    shape. CPU tensors take the plain version; CUDA tensors launch
    ``kzg_mont_mul`` (csrc/mont_mul.cu)."""
    if a.shape != b.shape or a.shape[0] != field.L:
        raise ValueError(f"mont_mul operands must share shape ({field.L}, ...)")
    if a.device.type == "cpu":
        return mont_mul_plain(a, b, field)
    _build.check_cuda(a, b)
    out = torch.empty_like(a)
    n = a.numel() // field.L
    if n == 0:  # no lanes, no launch
        return out
    _build.launch(f"mont_mul_{field.name.lower()}", "kzg_mont_mul",
                  a.data_ptr(), b.data_ptr(), out.data_ptr(), n, field.kernel_id)
    return out


# ---------------------------------------------------------------------------
# K1's batched inversion
# ---------------------------------------------------------------------------

INV_BLOCK = 256  # threads a block of the inversion kernels (kInvBlock in inv_batch.cu)
INV_RUN = 32  # lanes each thread of the first and last passes multiplies in turn


def inv_batch(a: torch.Tensor, field: Field) -> torch.Tensor:
    """Batched inversion wrapper: a (L, *batch) int32 canonical Montgomery
    words -> the words of each lane's inverse, zero lanes mapped to zero.
    CPU tensors take ``field.inv_batch_plain``; CUDA tensors launch
    ``kzg_inv_up``, ``kzg_inv_top`` and ``kzg_inv_down`` (csrc/inv_batch.cu),
    three launches whatever the lane count, with the scratch allocated here.
    The inverse is unique, so both give the same words."""
    if a.dim() < 2 or a.shape[0] != field.L:
        raise ValueError(f"inv_batch takes ({field.L}, ...) words, got {tuple(a.shape)}")
    if a.dtype != torch.int32:
        raise TypeError(f"inv_batch takes int32 words, got {a.dtype}")
    if a.numel() == 0:  # no lanes, no launch
        return torch.empty_like(a)
    if a.device.type == "cpu":
        return field.inv_batch_plain(a)
    flat = a.reshape(field.L, -1).contiguous()
    _build.check_cuda(flat)
    n = flat.shape[1]
    if n >= 1 << 31:
        raise ValueError("inv_batch takes fewer than 2^31 lanes")
    out = torch.empty_like(flat)
    g = -(-n // (INV_BLOCK * INV_RUN))
    tot = torch.empty(field.L, g, dtype=torch.int32, device=a.device)
    pre = torch.empty_like(tot)
    name = f"inv_batch_{field.name.lower()}"
    _build.launch(name, "kzg_inv_up", flat.data_ptr(), out.data_ptr(), tot.data_ptr(), n,
                  INV_RUN, field.kernel_id)
    _build.launch(name, "kzg_inv_top", tot.data_ptr(), pre.data_ptr(), g, field.kernel_id)
    _build.launch(name, "kzg_inv_down", flat.data_ptr(), out.data_ptr(), tot.data_ptr(), n,
                  INV_RUN, field.kernel_id)
    return out.reshape(a.shape)


FP = Field(hm.P, 12, "Fp", 0)  # 381-bit base field, 12 words
FR = Field(hm.R, 8, "Fr", 1)  # 255-bit scalar field, 8 words
