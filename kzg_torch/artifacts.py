"""Artifact persistence, byte-compatible with the reference's JSON files
(./artifacts/{setup,commitment,evaluation}.json; src/main.rs:101-104,310-320), as in
``kzg_tpu/artifacts.py``.

  setup.json      = [{"g1": [48 u8], "g2": [96 u8]}, ...]
  commitment.json = {"polynomial": {"coefficients": [[32 u8 LE] ...]},
                     "commitment": [48 u8]}
  evaluation.json = {"evaluation": {"point": [32 u8], "result": [32 u8]},
                     "proof": [48 u8]}

A setup.json of ``_BULK_LOAD_MIN`` points or more is decompressed in two
device batches (``ops/codec.py``: one for G1, one for G2, each checked for
the prime-order subgroup); a smaller one point by point on the host
(``SetupArtifact.from_json``), as ``kzg_tpu/artifacts.py:87-115`` does.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from .curves import G1Point, G2Point
from .errors import CliError, SerializationError
from .ops import codec
from .ops import curve as cv
from .polynomial import Evaluation, Polynomial
from .trusted_setup import SetupArtifact
from .utils.device import resolve_device

SETUP_ARTIFACTS_PATH = "./artifacts/setup.json"
COMMITMENT_ARTIFACTS_PATH = "./artifacts/commitment.json"
EVALUATION_ARTIFACTS_PATH = "./artifacts/evaluation.json"


def dumps(obj) -> str:
    """serde_json-compatible compact encoding (no whitespace)."""
    return json.dumps(obj, separators=(",", ":"))


def write_file(path: str, content: str):
    """Delete-then-recreate write (reference src/main.rs:117-120,178-182)."""
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    with open(path, "w") as f:
        f.write(content)


@dataclass
class CommitmentArtifact:
    polynomial: Polynomial
    commitment: G1Point

    def to_json(self) -> dict:
        return {"polynomial": self.polynomial.to_json(), "commitment": self.commitment.to_json()}

    @classmethod
    def from_json(cls, data: dict, device=None) -> "CommitmentArtifact":
        return cls(
            polynomial=Polynomial.from_json(data["polynomial"], device),
            commitment=G1Point.from_json(data["commitment"]),
        )


@dataclass
class EvaluationArtifact:
    evaluation: Evaluation
    proof: G1Point

    def to_json(self) -> dict:
        return {"evaluation": self.evaluation.to_json(), "proof": self.proof.to_json()}

    @classmethod
    def from_json(cls, data: dict) -> "EvaluationArtifact":
        return cls(
            evaluation=Evaluation.from_json(data["evaluation"]),
            proof=G1Point.from_json(data["proof"]),
        )


def save_setup(artifacts: list[SetupArtifact], path: str = SETUP_ARTIFACTS_PATH):
    write_file(path, dumps([a.to_json() for a in artifacts]))


_BULK_LOAD_MIN = 64  # below this the per-point host path is cheaper than the device batches


def load_setup(path: str = SETUP_ARTIFACTS_PATH, device=None) -> list[SetupArtifact]:
    """setup.json's artifacts. From ``_BULK_LOAD_MIN`` points on (on
    ``device``, the card unless asked): every entry's lengths checked
    first, then one G1 and one G2 device batch, each checked for the
    prime-order subgroup, with the per-point path's messages."""
    if not os.path.exists(path):
        raise CliError("Trusted setup artifacts have not been found, generate them beforehand.")
    with open(path) as f:
        raw = json.load(f)
    if len(raw) < _BULK_LOAD_MIN:
        return [SetupArtifact.from_json(a) for a in raw]
    for a in raw:
        for key, ln in (("g1", 48), ("g2", 96)):
            d = a[key]
            if not isinstance(d, list) or len(d) != ln:
                raise SerializationError(
                    f"Invalid byte array, expected length {ln}, got {len(d) if isinstance(d, list) else type(d)}"
                )
    device = resolve_device(device)
    g1 = codec.g1_decompress_batch([bytes(a["g1"]) for a in raw], True, device)
    g2 = codec.g2_decompress_batch([bytes(a["g2"]) for a in raw], True, device)
    # the decompressed points are affine (Z the Montgomery one, or zero at infinity)
    g1_pts = cv.G1.host_affine(g1[:2], cv.G1.is_inf(g1))
    g2_pts = cv.G2.host_affine(g2[:2], cv.G2.is_inf(g2))
    return [SetupArtifact(G1Point.from_affine(p1), G2Point.from_affine(p2))
            for p1, p2 in zip(g1_pts, g2_pts)]


def save_commitment(artifact: CommitmentArtifact, path: str = COMMITMENT_ARTIFACTS_PATH):
    write_file(path, dumps(artifact.to_json()))


def load_commitment(path: str = COMMITMENT_ARTIFACTS_PATH, device=None) -> CommitmentArtifact:
    if not os.path.exists(path):
        raise CliError("Commitment artifact has not been found, generate it beforehand.")
    with open(path) as f:
        return CommitmentArtifact.from_json(json.load(f), device)


def save_evaluation(artifact: EvaluationArtifact, path: str = EVALUATION_ARTIFACTS_PATH):
    write_file(path, dumps(artifact.to_json()))


def load_evaluation(path: str = EVALUATION_ARTIFACTS_PATH) -> EvaluationArtifact:
    if not os.path.exists(path):
        raise CliError("Evaluation artifact has not been found, generate it beforehand.")
    with open(path) as f:
        return EvaluationArtifact.from_json(json.load(f))
