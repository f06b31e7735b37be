"""Typed errors, as in ``kzg_tpu/errors.py``."""

from __future__ import annotations


class KzgError(Exception):
    """Base error for the kzg_torch package."""


class SerializationError(KzgError):
    """Bad artifact bytes (length / flags / field range / curve membership)."""


class ProtocolError(KzgError):
    """KZG protocol precondition failures (degree caps, ...)."""


class CliError(KzgError):
    """Command execution failures (missing artifacts, bad inputs)."""
