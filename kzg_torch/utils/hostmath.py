"""Exact python-int BLS12-381 arithmetic for the host side of the port.

The port's own copy of what it needs from ``kzg_tpu/utils/hostmath.py`` (that
module is jax-free, but importing it runs the jax-importing ``kzg_tpu``
package): the curve constants, Fp2, the affine group law over Fp (G1) and Fp2
(G2), the Fp and Fp2 square roots and ZCash-convention compression and
decompression of both groups with the subgroup checks. Used at the IO
boundary (compress / decompress), to derive the kernels' Montgomery
constants, and as the exact oracle in tests and in ``chip_smoke.py``.
"""

from __future__ import annotations

# Base field modulus (381 bits)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Scalar field modulus (255 bits)
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# G1: y^2 = x^3 + 4 over Fp; G2: y^2 = x^3 + 4(1 + u) over Fp2
B_G1 = 4
B_G2 = (4, 4)  # 4 + 4u
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)


def fp_inv(a: int) -> int:
    return pow(a, P - 2, P)


def fp_sqrt(a: int) -> int | None:
    """Square root in Fp (P = 3 mod 4 so a^((P+1)/4) works)."""
    a %= P
    if a == 0:
        return 0
    root = pow(a, (P + 1) // 4, P)
    return root if root * root % P == a else None


def fp_legendre(a: int) -> int:
    """Euler criterion: 1 if QR, P-1 if non-residue, 0 if zero."""
    return pow(a, (P - 1) // 2, P)


# ---------------------------------------------------------------------------
# Fp2 = Fp[u] / (u^2 + 1), elements as (c0, c1) == c0 + c1*u
# ---------------------------------------------------------------------------

FP2_ZERO = (0, 0)


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return (-a[0] % P, -a[1] % P)


def fp2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) with u^2 = -1
    return (
        (a[0] * b[0] - a[1] * b[1]) % P,
        (a[0] * b[1] + a[1] * b[0]) % P,
    )


def fp2_sq(a):
    return fp2_mul(a, a)


def fp2_inv(a):
    # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    inv_norm = fp_inv(norm)
    return (a[0] * inv_norm % P, -a[1] * inv_norm % P)


def fp2_sqrt(a):
    """Square root in Fp2 via the complex method (u^2 = -1).

    Returns a root y with y^2 = a, or None if a is not a square.
    """
    a0, a1 = a[0] % P, a[1] % P
    if a1 == 0:
        r = fp_sqrt(a0)
        if r is not None:
            return (r, 0)
        # sqrt(a0) = sqrt(-a0) * u  (since u^2 = -1)
        r = fp_sqrt(-a0 % P)
        if r is None:
            return None
        return (0, r)
    # norm = a0^2 + a1^2 must be a QR in Fp for a root to exist
    lam = fp_sqrt((a0 * a0 + a1 * a1) % P)
    if lam is None:
        return None
    # y0^2 = (a0 + lam)/2 (or (a0 - lam)/2), y1 = a1 / (2 y0)
    inv2 = fp_inv(2)
    delta = (a0 + lam) * inv2 % P
    if fp_legendre(delta) not in (0, 1):
        delta = (a0 - lam) * inv2 % P
    y0 = fp_sqrt(delta)
    if y0 is None:
        return None
    if y0 == 0:
        return None
    y1 = a1 * fp_inv(2 * y0 % P) % P
    y = (y0, y1)
    return y if fp2_sq(y) == (a0, a1) else None


# ---------------------------------------------------------------------------
# Short Weierstrass affine group law, generic over the field (Fp for G1, Fp2
# for G2). Points are (x, y) tuples; None is the point at infinity.
# ---------------------------------------------------------------------------


class _AffineOps:
    def __init__(self, add, sub, mul, sq, inv, zero, three):
        self.add, self.sub, self.mul, self.sq, self.inv = add, sub, mul, sq, inv
        self.zero, self.three = zero, three


_FP_OPS = _AffineOps(
    add=lambda a, b: (a + b) % P,
    sub=lambda a, b: (a - b) % P,
    mul=lambda a, b: a * b % P,
    sq=lambda a: a * a % P,
    inv=fp_inv,
    zero=0,
    three=3,
)

_FP2_OPS = _AffineOps(
    add=fp2_add,
    sub=fp2_sub,
    mul=fp2_mul,
    sq=fp2_sq,
    inv=fp2_inv,
    zero=FP2_ZERO,
    three=(3, 0),
)


def _affine_add(F: _AffineOps, p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 == y2:
            if y1 == F.zero:
                return None
            # tangent
            lam = F.mul(F.mul(F.sq(x1), F.three), F.inv(F.add(y1, y1)))
        else:
            return None
    else:
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    x3 = F.sub(F.sub(F.sq(lam), x1), x2)
    y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
    return (x3, y3)


def _affine_mul_unreduced(F: _AffineOps, p, k: int):
    result = None
    addend = p
    while k:
        if k & 1:
            result = _affine_add(F, result, addend)
        addend = _affine_add(F, addend, addend)
        k >>= 1
    return result


def g1_add(p, q):
    return _affine_add(_FP_OPS, p, q)


def g1_mul(p, k: int):
    return _affine_mul_unreduced(_FP_OPS, p, k % R)


def g1_neg(p):
    return None if p is None else (p[0], -p[1] % P)


def g2_add(p, q):
    return _affine_add(_FP2_OPS, p, q)


def g2_mul(p, k: int):
    return _affine_mul_unreduced(_FP2_OPS, p, k % R)


def g2_neg(p):
    return None if p is None else (p[0], fp2_neg(p[1]))


def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return y * y % P == (x * x * x + B_G1) % P


def g1_in_subgroup(p) -> bool:
    return g1_is_on_curve(p) and _affine_mul_unreduced(_FP_OPS, p, R) is None


def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return fp2_sq(y) == fp2_add(fp2_mul(fp2_sq(x), x), B_G2)


def g2_in_subgroup(p) -> bool:
    return g2_is_on_curve(p) and _affine_mul_unreduced(_FP2_OPS, p, R) is None


# ---------------------------------------------------------------------------
# ZCash-convention compression (48 bytes, big-endian x, flag bits in byte 0)
# ---------------------------------------------------------------------------

_FLAG_COMPRESSED = 0x80
_FLAG_INFINITY = 0x40
_FLAG_SIGN = 0x20


def _fp_sign(y: int) -> bool:
    """Lexicographically-largest convention: sign bit set iff y > (P-1)/2."""
    return y > (P - 1) // 2


def _fp2_sign(y) -> bool:
    """Sign of y = y0 + y1*u: compare y1 first, fall back to y0 if y1 == 0."""
    if y[1] != 0:
        return y[1] > (P - 1) // 2
    return y[0] > (P - 1) // 2


def g1_compress(p) -> bytes:
    if p is None:
        return bytes([_FLAG_COMPRESSED | _FLAG_INFINITY]) + bytes(47)
    x, y = p
    data = bytearray(x.to_bytes(48, "big"))
    data[0] |= _FLAG_COMPRESSED
    if _fp_sign(y):
        data[0] |= _FLAG_SIGN
    return bytes(data)


def g1_decompress(data: bytes):
    if len(data) != 48:
        raise ValueError(f"Invalid length, expected 48, got {len(data)}")
    flags = data[0]
    if not flags & _FLAG_COMPRESSED:
        raise ValueError("Expected compressed encoding")
    if flags & _FLAG_INFINITY:
        if flags & _FLAG_SIGN or any(data[1:]) or flags & 0x1F:
            raise ValueError("Malformed infinity encoding")
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("x coordinate not in field")
    y = fp_sqrt((x * x * x + B_G1) % P)
    if y is None:
        raise ValueError("Point not on curve")
    if _fp_sign(y) != bool(flags & _FLAG_SIGN):
        y = -y % P
    point = (x, y)
    if not g1_in_subgroup(point):
        raise ValueError("Point not in the prime-order subgroup")
    return point


def g2_compress(p) -> bytes:
    """96 bytes: big-endian x1 then x0, flag bits in byte 0, the sign of y
    by _fp2_sign."""
    if p is None:
        return bytes([_FLAG_COMPRESSED | _FLAG_INFINITY]) + bytes(95)
    (x0, x1), y = p
    data = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    data[0] |= _FLAG_COMPRESSED
    if _fp2_sign(y):
        data[0] |= _FLAG_SIGN
    return bytes(data)


def g2_decompress(data: bytes):
    """96 compressed bytes (big-endian x1 then x0, flag bits in byte 0) ->
    an affine G2 point over Fp2, or None for infinity; ValueError on a
    malformed encoding or a point off the curve or outside the subgroup."""
    if len(data) != 96:
        raise ValueError(f"Invalid length, expected 96, got {len(data)}")
    flags = data[0]
    if not flags & _FLAG_COMPRESSED:
        raise ValueError("Expected compressed encoding")
    if flags & _FLAG_INFINITY:
        if flags & _FLAG_SIGN or any(data[1:]) or flags & 0x1F:
            raise ValueError("Malformed infinity encoding")
        return None
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("x coordinate not in field")
    x = (x0, x1)
    y = fp2_sqrt(fp2_add(fp2_mul(fp2_sq(x), x), B_G2))
    if y is None:
        raise ValueError("Point not on curve")
    if _fp2_sign(y) != bool(flags & _FLAG_SIGN):
        y = fp2_neg(y)
    point = (x, y)
    if not g2_in_subgroup(point):
        raise ValueError("Point not in the prime-order subgroup")
    return point
