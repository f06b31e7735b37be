"""Polynomial over Fr and its commitment: the reference's ``Polynomial``
(src/polynomial.rs), as in ``kzg_tpu/polynomial.py:37-192``.

Coefficients live as ONE tensor of Montgomery Fr words, shape (8, n),
ascending degree, on the device the polynomial was built for. Semantics kept
exactly:
  - construction truncates trailing zero coefficients after the last
    non-zero one; an all-zero non-empty input keeps one zero coefficient, an
    empty input gives the zero polynomial with degree() == 0
    (src/polynomial.rs:55-100)
  - at most 2^32 - 1 coefficients (src/polynomial.rs:56-61)
  - divide_by_root rejects a constant non-zero polynomial and a non-root
    through the rebuilt-constant-term check (src/polynomial.rs:159-192)
  - commit requires degree + 1 <= len(setup) (src/polynomial.rs:201-205)
  - verification compares e(proof, s G2 - x G2) with e(C - y G1, G2)
    (src/polynomial.rs:276-294), both pairings in one batched call
"""

from __future__ import annotations

import torch

from .curves import G1Point
from .errors import ProtocolError
from .ops import curve as cv
from .ops import genmul
from .ops import msm as msmops
from .ops import pairing as devpair
from .ops import poly as polyops
from .ops.field import FR
from .scalar import Scalar
from .utils import hostmath as hm
from .utils.device import resolve_device

MAX_COEFFS = 2**32 - 1


class Polynomial:
    __slots__ = ("_coeffs",)

    def __init__(self, coeffs: torch.Tensor):
        """coeffs: (8, n) Montgomery Fr words, ascending degree, already
        normalized. Internal: use the from_* constructors."""
        self._coeffs = coeffs

    # -- constructors -------------------------------------------------------------

    @classmethod
    def from_ints(cls, values, device=None) -> "Polynomial":
        """From i128-semantics integer coefficients (ascending degree)."""
        device = resolve_device(device)
        if len(values) > MAX_COEFFS:
            raise ProtocolError(
                f"Too many coefficients for polynomial, only 2**32 - 1 coefficients is supported. Got {len(values)}"
            )
        vals = [v % hm.R for v in values]
        last = 0
        for i, v in enumerate(vals):
            if v != 0:
                last = i
        vals = vals[: last + 1]
        if not vals:
            return cls(torch.zeros(FR.L, 0, dtype=torch.int32, device=device))
        return cls(FR.tensor(vals, device))

    @classmethod
    def from_scalars(cls, values: list[Scalar], device=None) -> "Polynomial":
        return cls.from_ints([v.to_int() for v in values], device)

    @classmethod
    def from_constant(cls, a: Scalar, device=None) -> "Polynomial":
        """Order-0 polynomial; a zero constant gives the empty polynomial
        (src/polynomial.rs:78-89)."""
        if a.is_zero():
            return cls.from_ints([], device)
        return cls.from_ints([a.to_int()], device)

    @classmethod
    def _from_mont_words(cls, coeffs: torch.Tensor) -> "Polynomial":
        """The reference's normalization of a computed coefficient vector:
        truncate after the last non-zero coefficient (an all-zero non-empty
        vector keeps one zero)."""
        if coeffs.shape[1] == 0:
            return cls(coeffs)
        nz = (coeffs != 0).any(dim=0).nonzero()
        last = int(nz[-1]) + 1 if nz.numel() else 1
        return cls(coeffs[:, :last].contiguous())

    # -- views ----------------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._coeffs.device

    @property
    def num_coefficients(self) -> int:
        return int(self._coeffs.shape[1])

    def degree(self) -> int:
        """One less than the coefficient count; 0 for the zero polynomial."""
        n = self.num_coefficients
        return n - 1 if n else 0

    def coefficient_ints(self) -> list[int]:
        return FR.from_words_many(self._coeffs)

    def coefficients(self) -> list[Scalar]:
        return [Scalar(v) for v in self.coefficient_ints()]

    @property
    def coeffs_mont(self) -> torch.Tensor:
        """(8, n) Montgomery words: the kernel-facing view."""
        return self._coeffs

    # -- algebra ----------------------------------------------------------------------

    def evaluate(self, x: Scalar) -> "Evaluation":
        """P(x) (``ops.poly.evaluate``: kernel K1e on a CUDA tensor)."""
        y = polyops.evaluate(self._coeffs, x.mont(self.device))
        return Evaluation(point=x, result=Scalar(FR.from_words_many(y.reshape(FR.L, 1))[0]))

    def sub(self, other: "Polynomial") -> "Polynomial":
        """Coefficient-wise difference (the shorter one zero-padded),
        renormalized."""
        a, b = self._coeffs, other._coeffs
        n = max(a.shape[1], b.shape[1])
        a = torch.nn.functional.pad(a, (0, n - a.shape[1]))
        b = torch.nn.functional.pad(b, (0, n - b.shape[1]))
        return Polynomial._from_mont_words(FR.sub(a, b))

    def divide_by_root(self, root: Scalar) -> "Polynomial":
        """The quotient of the exact division by (x - root); raises
        ProtocolError when root is not a root."""
        n = self.num_coefficients
        if n == 0:
            return Polynomial(self._coeffs)
        if n == 1:
            # a lone zero coefficient is the zero polynomial (src/polynomial.rs:159-167)
            if not bool(self._coeffs.any()):
                return Polynomial(self._coeffs[:, :0])
            raise ProtocolError("Unable to divide a constant polynomial")
        quotient, rebuilt = polyops.synthetic_divide(self._coeffs, root.mont(self.device))
        if not torch.equal(rebuilt, self._coeffs[:, 0]):
            raise ProtocolError(
                "[divide_by_root] Fail to divide the polynomial by a root, constant terms do not add up"
            )
        return Polynomial._from_mont_words(quotient)

    # -- commitment -------------------------------------------------------------------

    def commit(self, setup) -> G1Point:
        """C = sum_i a_i (s^i G1) (reference hot loop src/polynomial.rs:207-214).

        ``setup`` is a list of SetupArtifact (reference parity) or a
        trusted_setup.DeviceSRS. With a DeviceSRS and n >= FIXED_BASE_THRESHOLD
        coefficients the MSM runs against the SRS's fixed-base tables; every
        other case runs the batched double-and-add MSM. Both give the same
        group element."""
        from .trusted_setup import DeviceSRS

        n = self.num_coefficients
        if self.degree() + 1 > len(setup):
            raise ProtocolError(
                "Setup does not allow for commitment generation of the polynomial. The polynomial degree is too high."
            )
        if n == 0:
            return G1Point.from_affine(None)
        scalars = FR.from_mont(self._coeffs)
        if isinstance(setup, DeviceSRS):
            if setup.device != self.device:
                raise ValueError(f"SRS on {setup.device}, polynomial on {self.device}")
            mask = setup.g1_inf[:n] if setup.g1_inf is not None else None
            if n >= msmops.FIXED_BASE_THRESHOLD:
                return G1Point(msmops.msm_g1_fixed(setup.fixed_tables(), scalars, inf_mask=mask))
            pts = (setup.g1_x[:, :n], setup.g1_y[:, :n])
            return G1Point(msmops.msm_batched_affine(pts, scalars, inf_mask=mask))
        x, y, z = cv.g1_to_device([a.g1.affine() for a in setup[:n]], self.device)
        inf = cv.FP.is_zero(z)
        mask = inf if bool(inf.any()) else None
        return G1Point(msmops.msm_batched_affine((x, y), scalars, inf_mask=mask))

    # -- serde -------------------------------------------------------------------------

    def to_json(self) -> dict:
        return {"coefficients": [list(v.to_bytes(32, "little")) for v in self.coefficient_ints()]}

    @classmethod
    def from_json(cls, data: dict, device=None) -> "Polynomial":
        return cls.from_scalars([Scalar.from_json(c) for c in data["coefficients"]], device)


class Evaluation:
    """{point, result} evaluation record (src/polynomial.rs:249-295)."""

    __slots__ = ("point", "result")

    def __init__(self, point: Scalar, result: Scalar):
        self.point = point
        self.result = result

    def generate_proof(self, polynomial: Polynomial, setup) -> G1Point:
        """pi = commit((P - y) / (x - point)) (src/polynomial.rs:260-269);
        the quotient's commit takes the same routes as Polynomial.commit."""
        constant = Polynomial.from_constant(self.result, polynomial.device)
        return polynomial.sub(constant).divide_by_root(self.point).commit(setup)

    def verify_proof(self, proof: G1Point, commitment: G1Point, setup, device=None) -> bool:
        """e(proof, s G2 - x G2) == e(C - y G1, G2) (src/polynomial.rs:276-294),
        through ``verify_proofs_batch`` with one item."""
        return verify_proofs_batch([proof], [commitment], [self], setup, device)[0]

    def to_json(self) -> dict:
        return {"point": self.point.to_json(), "result": self.result.to_json()}

    @classmethod
    def from_json(cls, data: dict) -> "Evaluation":
        return cls(point=Scalar.from_json(data["point"]), result=Scalar.from_json(data["result"]))

    def __repr__(self):
        return f"Evaluation(point={self.point}, result={self.result})"


def _g1_lanes(points, device):
    """G1Points -> one Jacobian triple (12, V) on ``device``: a device
    point's words as they are, a host point through ``cv.g1_to_device``
    (infinity as the zero words)."""
    cols = []
    for pt in points:
        if pt._jac is not None:
            cols.append(tuple(c.reshape(cv.FP.L, 1).to(device) for c in pt._jac))
        else:
            cols.append(cv.g1_to_device([pt.affine()], device))
    return tuple(torch.cat([c[k] for c in cols], dim=1) for k in range(3))


def verify_proofs_batch(proofs, commitments, evaluations, setup, device=None) -> list[bool]:
    """Verify V opening proofs in one batched pairing call
    (``kzg_tpu/polynomial.py:384-446``); item i holds as
    ``Evaluation.verify_proof`` does: e(pi_i, s G2 - x_i G2) ==
    e(C_i - y_i G1, G2). ``setup`` is a list of SetupArtifact or a
    DeviceSRS (its ``g2[1]`` is s G2); the work runs on the DeviceSRS's
    device, else on ``device`` (the card unless the caller asks for the
    CPU).

    x_i G2 and y_i G1 are ``genmul``'s generator multiplications (batched
    over V), s G2 - x_i G2 and C_i - y_i G1 one G2 and one G1 add; then
    lanes [0, V) pair (pi_i, s G2 - x_i G2) and lanes [V, 2V)
    (C_i - y_i G1, G2) in one ``pairing`` call (K10 and K11 once each), and
    item i compares lane i with lane V + i. The JAX package pads V to a
    power of two so that one compiled XLA program serves every batch; here
    nothing is compiled per shape, so V is not padded."""
    from .trusted_setup import DeviceSRS

    if len(setup) < 2:
        raise ProtocolError("At least 2 setup artifacts are required for verification")
    v = len(proofs)
    if not (len(commitments) == len(evaluations) == v):
        raise ProtocolError("proofs/commitments/evaluations length mismatch")
    if v == 0:
        return []
    if isinstance(setup, DeviceSRS):
        device, s_g2 = setup.device, setup.g2[1]
    else:
        device, s_g2 = resolve_device(device), setup[1].g2

    xs = cv.fr_std_words([ev.point.to_int() for ev in evaluations], device)
    ys = cv.fr_std_words([ev.result.to_int() for ev in evaluations], device)
    # s G2 - x G2 (the left pairings' G2 side)
    s_jac = cv.g2_to_device([s_g2.affine()] * v, device)
    lhs_g2 = cv.g2_add(s_jac, cv.neg(genmul.mul_g2_gen(xs)))
    # C - y G1 (the right pairings' G1 side)
    rhs_g1 = cv.g1_add(_g1_lanes(commitments, device), cv.neg(genmul.mul_g1_gen(ys)))

    g1_all = tuple(torch.cat([a, b], dim=1) for a, b in zip(_g1_lanes(proofs, device), rhs_g1))
    g2_gen = cv.g2_to_device([hm.G2_GEN] * v, device)
    g2_all = tuple(torch.cat([a, b], dim=-1) for a, b in zip(lhs_g2, g2_gen))
    (g1x, g1y), g1inf = cv.to_affine(g1_all)
    (g2x, g2y), g2inf = cv.g2_to_affine(g2_all)
    out = devpair.pairing((g1x, g1y), g1inf, (g2x, g2y), g2inf)
    return (out[..., :v] == out[..., v:]).flatten(0, 3).all(dim=0).tolist()
