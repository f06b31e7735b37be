"""Exact python-int BLS12-381 arithmetic for the host side of the port.

The port's own copy of what it needs from ``kzg_tpu/utils/hostmath.py`` (that
module is jax-free, but importing it runs the jax-importing ``kzg_tpu``
package): the curve constants, the affine G1 group law, the Fp square root and
ZCash-convention G1 compression. Used at the IO boundary (compress /
decompress), to derive the kernels' Montgomery constants, and as the exact
oracle in tests and in ``chip_smoke.py``.
"""

from __future__ import annotations

# Base field modulus (381 bits)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Scalar field modulus (255 bits)
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# G1: y^2 = x^3 + 4 over Fp
B_G1 = 4
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
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


# ---------------------------------------------------------------------------
# Affine G1 group law; points are (x, y) tuples, None is the point at infinity.
# ---------------------------------------------------------------------------


def g1_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 != y2 or y1 == 0:
            return None
        lam = 3 * x1 * x1 * fp_inv(2 * y1) % P
    else:
        lam = (y2 - y1) * fp_inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def _mul_unreduced(p, k: int):
    result = None
    addend = p
    while k:
        if k & 1:
            result = g1_add(result, addend)
        addend = g1_add(addend, addend)
        k >>= 1
    return result


def g1_mul(p, k: int):
    return _mul_unreduced(p, k % R)


def g1_pow2_multiples(p, n: int) -> list:
    """[2^j p for j < n]: one chain of n - 1 doublings (the generator
    tables' level bases are 2^(8w + k) G for 256 exponents)."""
    out = [p]
    for _ in range(n - 1):
        out.append(g1_add(out[-1], out[-1]))
    return out


def g1_neg(p):
    return None if p is None else (p[0], -p[1] % P)


def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return y * y % P == (x * x * x + B_G1) % P


def g1_in_subgroup(p) -> bool:
    return g1_is_on_curve(p) and _mul_unreduced(p, R) is None


# ---------------------------------------------------------------------------
# ZCash-convention compression (48 bytes, big-endian x, flag bits in byte 0)
# ---------------------------------------------------------------------------

_FLAG_COMPRESSED = 0x80
_FLAG_INFINITY = 0x40
_FLAG_SIGN = 0x20


def _fp_sign(y: int) -> bool:
    """Lexicographically-largest convention: sign bit set iff y > (P-1)/2."""
    return y > (P - 1) // 2


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
