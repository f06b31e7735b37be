"""The group types: the reference's ``G1Point`` and ``G2Point``
(src/curves.rs), as in ``kzg_tpu/curves.py``.

A G1 point wraps a device Jacobian triple of (12,) Montgomery words, or
host affine ints, and converts between them on demand: an MSM result stays
on the device until its affine form, compression or JSON is asked for. A G2
point holds host affine ints. Compression follows the ZCash convention (48
bytes for G1, 96 for G2; src/curves.rs:99-110, :259-343) at the host
boundary. ``bilinear_map`` is the reference's pairing (src/curves.rs:355-371).
"""

from __future__ import annotations

from .errors import SerializationError
from .ops import curve as cv
from .utils import hostmath as hm
from .utils.device import resolve_device

_UNSET = object()


class G1Point:
    __slots__ = ("_jac", "_affine")

    def __init__(self, jac=None, affine=_UNSET):
        self._jac = jac  # (X, Y, Z), each (12,) int32 words, or None
        self._affine = affine  # host (x, y), None for infinity, or _UNSET

    @classmethod
    def from_affine(cls, p) -> "G1Point":
        """Host affine ints (x, y), or None for infinity."""
        return cls(None, p)

    def affine(self):
        """Host affine ints (x, y), or None for infinity."""
        if self._affine is _UNSET:
            self._affine = cv.g1_from_device(tuple(c.reshape(-1, 1) for c in self._jac))[0]
        return self._affine

    def is_infinity(self) -> bool:
        return self.affine() is None

    def compress(self) -> bytes:
        return hm.g1_compress(self.affine())

    @classmethod
    def decompress(cls, data: bytes) -> "G1Point":
        try:
            p = hm.g1_decompress(bytes(data))
        except ValueError as e:
            raise SerializationError(str(e)) from e
        return cls.from_affine(p)

    def to_json(self) -> list[int]:
        return list(self.compress())

    @classmethod
    def from_json(cls, data) -> "G1Point":
        if not isinstance(data, list) or len(data) != 48:
            raise SerializationError(
                f"Invalid byte array, expected length 48, got {len(data) if isinstance(data, list) else type(data)}"
            )
        return cls.decompress(bytes(data))

    def __eq__(self, other) -> bool:
        return isinstance(other, G1Point) and self.affine() == other.affine()

    def __hash__(self):
        return hash(("G1Point", self.affine()))

    def __repr__(self):
        return f"G1Point({self.affine()})"


class G2Point:
    """A G2 point (``kzg_tpu/curves.py:129-167``): host affine ints, their
    compression and JSON. Its group operations run on the device where they
    are needed (``ops/curve.py``'s G2 kernels, K9)."""

    __slots__ = ("_affine",)

    def __init__(self, affine):
        self._affine = affine  # host ((x0, x1), (y0, y1)), None for infinity

    @classmethod
    def from_affine(cls, p) -> "G2Point":
        """Host affine Fp2 ints ((x0, x1), (y0, y1)), or None for infinity."""
        return cls(p)

    def affine(self):
        """Host affine Fp2 ints, or None for infinity."""
        return self._affine

    def is_infinity(self) -> bool:
        return self.affine() is None

    def compress(self) -> bytes:
        return hm.g2_compress(self.affine())

    @classmethod
    def decompress(cls, data: bytes) -> "G2Point":
        """96 compressed bytes, checked on the host (flags, field range,
        curve, subgroup: hostmath.g2_decompress)."""
        try:
            p = hm.g2_decompress(bytes(data))
        except (TypeError, ValueError) as e:
            raise SerializationError(str(e)) from e
        return cls.from_affine(p)

    def to_json(self) -> list[int]:
        return list(self.compress())

    @classmethod
    def from_json(cls, data) -> "G2Point":
        if not isinstance(data, list) or len(data) != 96:
            raise SerializationError(
                f"Invalid byte array, expected length 96, got {len(data) if isinstance(data, list) else type(data)}"
            )
        return cls.decompress(data)

    def __eq__(self, other) -> bool:
        return isinstance(other, G2Point) and self.affine() == other.affine()

    def __hash__(self):
        return hash(("G2Point", self.affine()))

    def __repr__(self):
        return f"G2Point({self.affine()})"


def bilinear_map(p1: G1Point, p2: G2Point, device=None):
    """The canonical reduced optimal ate pairing e(P, Q) as the oracle's Fp12
    tuple of ints (``kzg_tpu/curves.py:169``; src/curves.rs:355-371, blst's
    miller loop and final exponentiation): the Miller loop (K10) and the
    final exponentiation (K11) on ``device`` (the card unless the caller asks
    for the CPU). Infinity on either side gives one (``hostmath.FP12_ONE``)."""
    from .ops import pairing as devpair

    return devpair.pairing_points(p1, p2, resolve_device(device))
