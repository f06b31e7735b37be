"""kzg_torch: the PyTorch / CUDA port of kzg_tpu for NVIDIA Hopper.

Laid out like ``kzg_tpu``; imports torch and never jax or kzg_tpu. Entry
points run on the first CUDA card unless the caller passes ``device="cpu"``.
The kernels (``csrc/``) are built with nvcc on first use.
"""

from .curves import G1Point, G2Point, bilinear_map
from .errors import CliError, KzgError, ProtocolError, SerializationError
from .polynomial import Evaluation, Polynomial
from .scalar import Scalar
from .trusted_setup import DeviceSRS, SetupArtifact, SetupArtifactsGenerator, generate_setup

__all__ = [
    "G1Point",
    "G2Point",
    "bilinear_map",
    "CliError",
    "KzgError",
    "ProtocolError",
    "SerializationError",
    "Evaluation",
    "Polynomial",
    "Scalar",
    "DeviceSRS",
    "SetupArtifact",
    "SetupArtifactsGenerator",
    "generate_setup",
]
