"""Trusted-setup (powers-of-tau) artifacts, the ceremony that makes them and
the device-resident SRS, as in ``kzg_tpu/trusted_setup.py``.

The reference emits artifacts one at a time, s^k by a running product and
each point a fresh 256-bit ladder (src/trusted_setup.rs:40-78). Here the
powers of a chunk are one power ladder (``ops/poly.py``) and its G1 and G2
points one batched generator multiplication each (``ops/genmul.py``: the
window tables, or below GENMUL_TABLE_THRESHOLD points in a process without
them the 256-step ladder), made affine on the device. ``generate_setup``
and ``SetupArtifactsGenerator`` give the reference's items in its order:
k = 0 the two generators (src/trusted_setup.rs:41-48), then s^k G1 and
s^k G2.
"""

from __future__ import annotations

import collections
import json
from dataclasses import dataclass

import torch

from .curves import G1Point, G2Point
from .ops import codec
from .ops import curve as cv
from .ops import genmul
from .ops import msm as msmops
from .ops import poly as polyops
from .ops.field import FR
from .scalar import Scalar
from .utils import hostmath as hm
from .utils.device import resolve_device


@dataclass
class SetupArtifact:
    """{g1: s^k G1, g2: s^k G2} (src/trusted_setup.rs:31-35)."""

    g1: G1Point
    g2: G2Point

    def to_json(self) -> dict:
        return {"g1": self.g1.to_json(), "g2": self.g2.to_json()}

    @classmethod
    def from_json(cls, data: dict) -> "SetupArtifact":
        """Each point decoded and checked on the host (flags, field range,
        curve, subgroup), G1 first: about 0.2 s a G2 point, so large files
        go through ``artifacts.load_setup``'s device batches."""
        return cls(g1=G1Point.from_json(data["g1"]), g2=G2Point.from_json(data["g2"]))


def _generators() -> SetupArtifact:
    return SetupArtifact(G1Point.from_affine(hm.G1_GEN), G2Point.from_affine(hm.G2_GEN))


def _artifacts(ks: torch.Tensor) -> list[SetupArtifact]:
    """{k G1, k G2} for each lane of the (8, n) standard-form words ks: the
    generator multiplications, one affine conversion a group on the device,
    then host ints."""
    g1 = cv.G1.host_affine(*cv.to_affine(genmul.mul_g1_gen(ks)))
    g2 = cv.G2.host_affine(*cv.g2_to_affine(genmul.mul_g2_gen(ks)))
    return [SetupArtifact(G1Point.from_affine(p1), G2Point.from_affine(p2))
            for p1, p2 in zip(g1, g2)]


def generate_setup(secret: Scalar, count: int, chunk: int = 8192,
                   device=None) -> list[SetupArtifact]:
    """[{s^k G1, s^k G2} for k < count] (``kzg_tpu/trusted_setup.py:41-72``):
    item 0 the generators, then the powers s^1 .. s^(count - 1) from one
    power ladder, their points ``chunk`` at a time."""
    if count <= 0:
        return []
    out = [_generators()]
    if count == 1:
        return out
    device = resolve_device(device)
    std = FR.from_mont(polyops.power_sequence(secret.mont(device), count))
    for lo in range(1, count, chunk):
        out.extend(_artifacts(std[:, lo : min(lo + chunk, count)]))
    return out


class SetupArtifactsGenerator:
    """The reference's endless iterator (first item the generators, then
    the s^k pairs), its device work done ``chunk`` items at a time
    (``kzg_tpu/trusted_setup.py:75-120``).

    * ``secret`` - 32 big-endian bytes (src/trusted_setup.rs:16-28)
    """

    def __init__(self, secret: bytes, chunk: int = 16, device=None):
        self.secret = Scalar.from_be_bytes(secret)
        self._chunk = max(2, chunk)
        self._device = resolve_device(device)
        self._buf: collections.deque = collections.deque()
        self._next_k = 0
        self._power = Scalar.from_int(1)  # s^k0 when the next chunk starts at k0

    def __iter__(self):
        return self

    def __next__(self) -> SetupArtifact:
        if not self._buf:
            self._fill()
        return self._buf.popleft()

    def _fill(self):
        if self._next_k == 0:
            self._buf.append(_generators())
            self._next_k = 1
            self._power = self.secret
            return
        n = self._chunk
        # s^k0 .. s^(k0 + n - 1) = s^k0 [s^0 .. s^(n - 1)]
        pw = FR.mul(polyops.power_sequence(self.secret.mont(self._device), n),
                    self._power.mont(self._device)[:, None])
        self._buf.extend(_artifacts(FR.from_mont(pw)))
        self._power = self._power.mul(self.secret.pow(n))
        self._next_k += n

    def take(self, n: int) -> list[SetupArtifact]:
        return [next(self) for _ in range(n)]


class DeviceSRS:
    """Device-resident SRS: the G1 powers as affine word arrays ready for the
    MSM (no per-commit host conversion), the G2 points verifying needs, and,
    built on first use and cached, the fixed-base tables."""

    def __init__(self, g1_x: torch.Tensor, g1_y: torch.Tensor, g1_inf, g2, count: int):
        self.g1_x = g1_x  # (12, n) Montgomery affine
        self.g1_y = g1_y
        self.g1_inf = g1_inf  # (n,) bool or None
        self.g2 = g2  # list of G2Point ([0] and [1] are what verify needs)
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

    @classmethod
    def load(cls, path: str, subgroup_check: bool = True, device=None) -> "DeviceSRS":
        """setup.json straight to the device (``kzg_tpu/trusted_setup.py:182-203``):
        the G1 points decompressed in one device batch, each checked for the
        prime-order subgroup unless asked not to; the first two G2 points
        (what verify needs) on the host."""
        device = resolve_device(device)
        with open(path) as f:
            raw = json.load(f)
        jac = codec.g1_decompress_batch([bytes(a["g1"]) for a in raw], subgroup_check, device)
        (x, y), inf = cv.to_affine(jac)
        g2s = [G2Point.from_json(a["g2"]) for a in raw[:2]]
        return cls(x, y, inf if bool(inf.any()) else None, g2s, len(raw))
