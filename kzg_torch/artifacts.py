"""Artifact persistence, byte-compatible with the reference's JSON files
(./artifacts/{setup,commitment,evaluation}.json; src/main.rs:101-104,310-320), as in
``kzg_tpu/artifacts.py``.

  setup.json      = [{"g1": [48 u8], "g2": [96 u8]}, ...]
  commitment.json = {"polynomial": {"coefficients": [[32 u8 LE] ...]},
                     "commitment": [48 u8]}
  evaluation.json = {"evaluation": {"point": [32 u8], "result": [32 u8]},
                     "proof": [48 u8]}

Setup points are decompressed one by one on the host; the batched device
decompression of large setups is a later slice of the port.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from .curves import G1Point
from .errors import CliError
from .polynomial import Evaluation, Polynomial
from .trusted_setup import SetupArtifact

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


def load_setup(path: str = SETUP_ARTIFACTS_PATH) -> list[SetupArtifact]:
    if not os.path.exists(path):
        raise CliError("Trusted setup artifacts have not been found, generate them beforehand.")
    with open(path) as f:
        return [SetupArtifact.from_json(a) for a in json.load(f)]


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
