"""Host runtime pieces the port needs (request cancellation)."""

from .engine import Context

__all__ = ["Context"]
