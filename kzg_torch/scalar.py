"""Fr scalar type: the reference's ``Scalar`` (src/scalar.rs) with i128
construction semantics, as ``kzg_tpu/scalar.py``.

A scalar is one field element, so its value is kept as a canonical python
int; bulk Fr arithmetic runs on tensors in ``kzg_torch.ops.field.FR``.
``mont(device)`` gives the Montgomery words for device code.

  - ``from_i128``: negative (and zero) inputs map to ``r - |v|`` through the
    modulus (src/scalar.rs:27-48), arithmetically ``v mod r``.
  - JSON: a scalar is an array of its 32 little-endian bytes, and reading
    checks the length is 32 (src/scalar.rs:226-275).
"""

from __future__ import annotations

import torch

from .errors import KzgError
from .ops.field import FR
from .utils import hostmath as hm


class Scalar:
    __slots__ = ("_int",)

    def __init__(self, value: int):
        self._int = value % hm.R

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_int(cls, value: int) -> "Scalar":
        return cls(value)

    @classmethod
    def from_i128(cls, value: int) -> "Scalar":
        if not (-(2**127) <= value <= 2**127 - 1):
            raise KzgError(f"Value out of i128 range: {value}")
        return cls(value)

    @classmethod
    def from_le_bytes(cls, b) -> "Scalar":
        b = bytes(b)
        if len(b) != 32:
            raise KzgError(f"Invalid byte array, expected length 32, got {len(b)}")
        return cls(int.from_bytes(b, "little"))

    @classmethod
    def from_be_bytes(cls, b) -> "Scalar":
        b = bytes(b)
        if len(b) != 32:
            raise KzgError(f"Invalid byte array, expected length 32, got {len(b)}")
        return cls(int.from_bytes(b, "big"))

    # -- views ------------------------------------------------------------------

    def to_int(self) -> int:
        return self._int

    def to_le_bytes(self) -> bytes:
        return self._int.to_bytes(32, "little")

    def to_be_bytes(self) -> bytes:
        return self._int.to_bytes(32, "big")

    def mont(self, device) -> torch.Tensor:
        """(8,) Montgomery Fr words on ``device``."""
        return FR.tensor([self._int], device)[:, 0]

    # -- arithmetic ---------------------------------------------------------------

    def add(self, other: "Scalar") -> "Scalar":
        return Scalar(self._int + other._int)

    def sub(self, other: "Scalar") -> "Scalar":
        return Scalar(self._int - other._int)

    def mul(self, other: "Scalar") -> "Scalar":
        return Scalar(self._int * other._int)

    def neg(self) -> "Scalar":
        return Scalar(-self._int)

    def pow(self, n: int) -> "Scalar":
        """self^n for a non-negative machine integer n (src/scalar.rs:122-187)."""
        return Scalar(pow(self._int, int(n), hm.R))

    def is_zero(self) -> bool:
        return self._int == 0

    def __eq__(self, other) -> bool:
        return isinstance(other, Scalar) and self._int == other._int

    def __hash__(self):
        return hash(self._int)

    def __repr__(self) -> str:
        return f"Scalar({self._int})"

    def __str__(self) -> str:
        return str(self._int)

    # -- serde (JSON array of 32 LE bytes) -------------------------------------------

    def to_json(self) -> list[int]:
        return list(self.to_le_bytes())

    @classmethod
    def from_json(cls, data) -> "Scalar":
        if not isinstance(data, list):
            raise KzgError("Sequence of u8 expected for Scalar")
        if len(data) != 32:
            raise KzgError(f"Invalid byte array, expected length 32, got {len(data)}")
        return cls.from_le_bytes(data)
