"""Trusted-setup artifacts and the device-resident SRS, as in
``kzg_tpu/trusted_setup.py`` (SetupArtifact, DeviceSRS).

A SetupArtifact's G2 point is decoded and checked on the host as the JAX
package's ``G2Point.from_json`` does (flags, field range, curve, subgroup;
``hostmath.g2_decompress``) and kept as its 96 compressed bytes, which
``to_json`` writes back unchanged: commit does not use it, and the G2 group
on the device is a later slice of the port. The ceremony (generate_setup) is
too.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .curves import G1Point
from .errors import SerializationError
from .ops import curve as cv
from .ops import msm as msmops
from .utils import hostmath as hm
from .utils.device import resolve_device


@dataclass
class SetupArtifact:
    """{g1: s^k G1, g2: s^k G2} (src/trusted_setup.rs:31-35)."""

    g1: G1Point
    g2: bytes  # compressed G2 point, 96 bytes, checked by from_json

    def to_json(self) -> dict:
        return {"g1": self.g1.to_json(), "g2": list(self.g2)}

    @classmethod
    def from_json(cls, data: dict) -> "SetupArtifact":
        g1 = G1Point.from_json(data["g1"])
        g2 = data["g2"]
        if not isinstance(g2, list) or len(g2) != 96:
            raise SerializationError(
                f"Invalid byte array, expected length 96, got {len(g2) if isinstance(g2, list) else type(g2)}"
            )
        try:
            g2_bytes = bytes(g2)
            hm.g2_decompress(g2_bytes)
        except (TypeError, ValueError) as e:
            raise SerializationError(str(e)) from e
        return cls(g1=g1, g2=g2_bytes)


class DeviceSRS:
    """Device-resident SRS: the G1 powers as affine word arrays ready for the
    MSM (no per-commit host conversion), the compressed G2 points verifying
    needs, and, built on first use and cached, the fixed-base tables."""

    def __init__(self, g1_x: torch.Tensor, g1_y: torch.Tensor, g1_inf, g2, count: int):
        self.g1_x = g1_x  # (12, n) Montgomery affine
        self.g1_y = g1_y
        self.g1_inf = g1_inf  # (n,) bool or None
        self.g2 = g2  # list of compressed G2 bytes ([0] and [1] are what verify needs)
        self.count = count
        self._fb_tables = None

    def __len__(self) -> int:
        return self.count

    @property
    def device(self) -> torch.device:
        return self.g1_x.device

    def fixed_tables(self):
        """The fixed-base window tables as the scan reads them, point-major
        (16 n2, 24) (ops.msm.precompute_g1_tables, point_table), built once
        and cached: the SRS is fixed across commits. The limb-major tables
        the build makes are freed once the point-major copy exists."""
        if self._fb_tables is None:
            tables = msmops.precompute_g1_tables((self.g1_x, self.g1_y), self.g1_inf)
            self._fb_tables = msmops.point_table(tables)
        return self._fb_tables

    @classmethod
    def from_artifacts(cls, setup_artifacts, device=None) -> "DeviceSRS":
        device = resolve_device(device)
        pts = [a.g1.affine() for a in setup_artifacts]
        x, y, z = cv.g1_to_device(pts, device)
        inf = cv.FP.is_zero(z)
        g2s = [a.g2 for a in setup_artifacts[:2]]
        return cls(x, y, inf if bool(inf.any()) else None, g2s, len(setup_artifacts))
