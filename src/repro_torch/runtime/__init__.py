"""Serving runtime of the port: the LM's continuous-batching engine and
the synchronous KRR micro-batcher."""
from .serve_loop import (KRRRequest, KRRServeEngine, Request, ServeEngine,
                         greedy_sample, make_serve_step)

__all__ = ["KRRRequest", "KRRServeEngine", "Request", "ServeEngine",
           "greedy_sample", "make_serve_step"]
