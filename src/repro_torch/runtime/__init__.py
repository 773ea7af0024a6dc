"""Runtime of the port: the LM's continuous-batching engine, the
synchronous KRR micro-batcher, the train step and the fault-tolerant
training driver."""
from .fault_tolerance import (DriverConfig, StepFailure, StragglerStats,
                              TrainDriver)
from .serve_loop import (KRRRequest, KRRServeEngine, Request, ServeEngine,
                         greedy_sample, make_serve_step)
from .train_loop import TrainStepOut, init_train_state, make_train_step

__all__ = ["DriverConfig", "StepFailure", "StragglerStats", "TrainDriver",
           "KRRRequest", "KRRServeEngine", "Request", "ServeEngine",
           "greedy_sample", "make_serve_step", "TrainStepOut",
           "init_train_state", "make_train_step"]
