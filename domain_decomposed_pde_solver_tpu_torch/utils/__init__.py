"""Utilities: explicit device resolution, the native host library, and
adoption of the JAX package's arrays."""

from .device import resolve_device

__all__ = ["resolve_device"]
