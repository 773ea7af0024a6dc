"""Serving runtime of the port: the LM's continuous-batching engine."""
from .serve_loop import Request, ServeEngine, greedy_sample, make_serve_step

__all__ = ["Request", "ServeEngine", "greedy_sample", "make_serve_step"]
