"""Serve-plane primitives of the port: the request queue."""
from .queue import FifoQueue

__all__ = ["FifoQueue"]
