"""Exact python-int BLS12-381 arithmetic for the host side of the port.

The port's own copy of what it needs from ``kzg_tpu/utils/hostmath.py`` (that
module is jax-free, but importing it runs the jax-importing ``kzg_tpu``
package): the curve constants, Fp2, the Fp6 / Fp12 tower with its Frobenius
coefficients, the affine group law over Fp (G1) and Fp2 (G2), the Fp and Fp2
square roots, ZCash-convention compression and decompression of both groups
with the subgroup checks, and the optimal ate pairing (untwisted Miller loop
and the full final exponentiation). Used at the IO boundary (compress /
decompress), to derive the kernels' Montgomery constants and the Frobenius
tables, and as the exact oracle in tests and in ``chip_smoke.py``.
"""

from __future__ import annotations

# Base field modulus (381 bits)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Scalar field modulus (255 bits)
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x = -0xd201000000010000: |x| here, its sign below
BLS_X = 0xD201000000010000
BLS_X_IS_NEG = True

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
FP2_ONE = (1, 0)


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


def fp2_mul_fp(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def fp2_sq(a):
    return fp2_mul(a, a)


def fp2_conj(a):
    return (a[0], -a[1] % P)


def fp2_inv(a):
    # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    inv_norm = fp_inv(norm)
    return (a[0] * inv_norm % P, -a[1] * inv_norm % P)


def fp2_pow(a, e: int):
    result = FP2_ONE
    base = a
    while e:
        if e & 1:
            result = fp2_mul(result, base)
        base = fp2_sq(base)
        e >>= 1
    return result


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
# Fp6 = Fp2[v] / (v^3 - XI), XI = 1 + u. Elements: (c0, c1, c2) of Fp2.
# Fp12 = Fp6[w] / (w^2 - v). Elements: (c0, c1) of Fp6.
# ---------------------------------------------------------------------------

XI = (1, 1)  # the sextic non-residue 1 + u

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)
FP12_ZERO = (FP6_ZERO, FP6_ZERO)
FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp6_add(a, b):
    return tuple(fp2_add(x, y) for x, y in zip(a, b))


def fp6_sub(a, b):
    return tuple(fp2_sub(x, y) for x, y in zip(a, b))


def fp6_neg(a):
    return tuple(fp2_neg(x) for x in a)


def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    c0 = fp2_add(t0, fp2_mul(XI, fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), fp2_add(t1, t2))))
    c1 = fp2_add(
        fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), fp2_add(t0, t1)),
        fp2_mul(XI, t2),
    )
    c2 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), fp2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fp6_mul_by_v(a):
    """Multiply by v: (c0, c1, c2) -> (XI*c2, c0, c1)."""
    return (fp2_mul(XI, a[2]), a[0], a[1])


def fp6_sq(a):
    return fp6_mul(a, a)


def fp6_inv(a):
    a0, a1, a2 = a
    t0 = fp2_sub(fp2_sq(a0), fp2_mul(XI, fp2_mul(a1, a2)))
    t1 = fp2_sub(fp2_mul(XI, fp2_sq(a2)), fp2_mul(a0, a1))
    t2 = fp2_sub(fp2_sq(a1), fp2_mul(a0, a2))
    denom = fp2_add(
        fp2_mul(a0, t0),
        fp2_mul(XI, fp2_add(fp2_mul(a2, t1), fp2_mul(a1, t2))),
    )
    f = fp2_inv(denom)
    return (fp2_mul(t0, f), fp2_mul(t1, f), fp2_mul(t2, f))


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), fp6_add(t0, t1))
    return (c0, c1)


def fp12_sq(a):
    return fp12_mul(a, a)


def fp12_conj(a):
    """Conjugation == Frobenius^6: (c0, c1) -> (c0, -c1)."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    a0, a1 = a
    denom = fp6_sub(fp6_sq(a0), fp6_mul_by_v(fp6_sq(a1)))
    f = fp6_inv(denom)
    return (fp6_mul(a0, f), fp6_neg(fp6_mul(a1, f)))


def fp12_pow(a, e: int):
    result = FP12_ONE
    base = a
    while e:
        if e & 1:
            result = fp12_mul(result, base)
        base = fp12_sq(base)
        e >>= 1
    return result


# ---------------------------------------------------------------------------
# Frobenius coefficients (the pairing's constant tables)
# ---------------------------------------------------------------------------


def fp2_frobenius(a, k: int):
    """a^(p^k) in Fp2: conjugation if k odd."""
    return fp2_conj(a) if k % 2 == 1 else a


_FROB6 = None
_FROB12 = None


def _frob_tables():
    """({k: [XI^((p^k - 1) / 3), XI^(2 (p^k - 1) / 3)]}, {k: XI^((p^k - 1) / 6)})
    for k in 1..3."""
    global _FROB6, _FROB12
    if _FROB6 is None:
        _FROB6 = {k: [fp2_pow(XI, i * (P**k - 1) // 3) for i in (1, 2)] for k in (1, 2, 3)}
        _FROB12 = {k: fp2_pow(XI, (P**k - 1) // 6) for k in (1, 2, 3)}
    return _FROB6, _FROB12


def fp6_frobenius(a, k: int):
    frob6, _ = _frob_tables()
    g = frob6[k]
    return (
        fp2_frobenius(a[0], k),
        fp2_mul(fp2_frobenius(a[1], k), g[0]),
        fp2_mul(fp2_frobenius(a[2], k), g[1]),
    )


def fp12_frobenius(a, k: int):
    """a^(p^k) for k in 1..3."""
    _, frob12 = _frob_tables()
    g = frob12[k]
    c0 = fp6_frobenius(a[0], k)
    c1 = fp6_frobenius(a[1], k)
    c1 = tuple(fp2_mul(x, g) for x in c1)
    return (c0, c1)


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
# Optimal ate pairing (oracle): untwist-based Miller loop + full final exp.
# Slow but simple; used only in tests and never on the device path.
# ---------------------------------------------------------------------------

# w in Fp12 (w^2 = v): the element (0, 1) in the Fp6[w] representation
_W = (FP6_ZERO, FP6_ONE)
_W2 = fp12_mul(_W, _W)
_W3 = fp12_mul(_W2, _W)
_W2_INV = fp12_inv(_W2)
_W3_INV = fp12_inv(_W3)


def _fp_to_fp12(a: int):
    return (((a % P, 0), FP2_ZERO, FP2_ZERO), FP6_ZERO)


def _fp2_to_fp12(a):
    return ((a, FP2_ZERO, FP2_ZERO), FP6_ZERO)


def untwist(q):
    """Map a point on the twist E'(Fp2) to E(Fp12): (x, y) -> (x / w^2, y / w^3)."""
    if q is None:
        return None
    x, y = q
    return (fp12_mul(_fp2_to_fp12(x), _W2_INV), fp12_mul(_fp2_to_fp12(y), _W3_INV))


def _line(t1, t2, p12):
    """Evaluate the line through t1, t2 (E(Fp12) affine points) at p12 = (xP, yP)."""
    x1, y1 = t1
    x2, y2 = t2
    xp, yp = p12
    if x1 != x2:
        lam = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
    elif y1 == y2:
        three_x1_sq = fp12_mul(_fp_to_fp12(3), fp12_mul(x1, x1))
        lam = fp12_mul(three_x1_sq, fp12_inv(fp12_add(y1, y1)))
    else:
        return fp12_sub(xp, x1)
    return fp12_sub(fp12_sub(yp, y1), fp12_mul(lam, fp12_sub(xp, x1)))


def _fp12_affine_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 != y2:
            return None
        lam = fp12_mul(fp12_mul(_fp_to_fp12(3), fp12_mul(x1, x1)), fp12_inv(fp12_add(y1, y1)))
    else:
        lam = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
    x3 = fp12_sub(fp12_sub(fp12_mul(lam, lam), x1), x2)
    y3 = fp12_sub(fp12_mul(lam, fp12_sub(x1, x3)), y1)
    return (x3, y3)


def miller_loop(p, q):
    """f_{|x|, Q'}(P) in Fp12 where Q' = untwist(Q). p in G1 affine, q in G2 affine."""
    if p is None or q is None:
        return FP12_ONE
    q12 = untwist(q)
    p12 = (_fp_to_fp12(p[0]), _fp_to_fp12(p[1]))
    t = q12
    f = FP12_ONE
    for bit_index in range(BLS_X.bit_length() - 2, -1, -1):
        f = fp12_mul(fp12_sq(f), _line(t, t, p12))
        t = _fp12_affine_add(t, t)
        if (BLS_X >> bit_index) & 1:
            f = fp12_mul(f, _line(t, q12, p12))
            t = _fp12_affine_add(t, q12)
    return f


def final_exponentiation(f):
    """f^((p^12 - 1) / r)."""
    return fp12_pow(f, (P**12 - 1) // R)


def pairing(p, q):
    """Reduced optimal ate pairing e(P, Q). P in G1 affine, Q in G2 affine.

    The BLS parameter x is negative, so the Miller value is inverted before the
    final exponentiation (the vertical-line cofactor dies under the exponent).
    """
    f = miller_loop(p, q)
    if BLS_X_IS_NEG:
        f = fp12_inv(f)
    return final_exponentiation(f)


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
