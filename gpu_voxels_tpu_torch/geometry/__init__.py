"""Geometry helpers: rigid transforms and deterministic test geometry."""
from . import generation, transforms

__all__ = ["generation", "transforms"]
