"""Serving runtime: lock-step continuous batching over the decode step,
and the synchronous KRR micro-batcher.

``make_serve_step`` returns the one-token step; ``ServeEngine`` is the
host-side loop that admits requests into free slots, feeds one token per
slot per step (prompt tokens while a slot prefills, then its last
generated token), decodes in lock-step and retires finished sequences.

``KRRServeEngine`` is the KRR counterpart: a synchronous adapter over the
serve plane's building blocks (``repro_torch.serve``) — requests queue
through the shared ``FifoQueue`` and each ``step`` serves one fixed-size
micro-batch from the engine's ``ModelSlot`` snapshot. Fill-or-timeout
batching, deadlines and hot swap under load are
``repro_torch.serve.AsyncServeEngine``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch import Tensor

from ..configs.base import ModelConfig
from ..models import decode_step, init_decode_state
from ..serve.queue import FifoQueue
from ..serve.slot import ModelSlot


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(params, tokens (b, 1) | embeds (b, 1, d), caches) → (logits,
    caches); the vision and audio configs take embeddings."""

    def serve_step(params: Any, tokens: Tensor, caches: Any):
        if cfg.modality in ("vision", "audio"):
            return decode_step(params, cfg, None, caches, embeds=tokens)
        return decode_step(params, cfg, tokens, caches)

    return serve_step


def greedy_sample(logits: Tensor) -> Tensor:
    """The arg-max token of the last position: (b, s, v) → (b, 1), or
    (b, s, codebooks, v) → (b, codebooks)."""
    if logits.ndim == 4:
        return torch.argmax(logits[:, -1], dim=-1)
    return torch.argmax(logits[:, -1], dim=-1, keepdim=True)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Lock-step continuous batching over a fixed slot count (batch dim).

    Every engine step feeds ONE token per slot, so the single global cache
    write pointer advances uniformly, and per-slot ``start`` offsets (set
    at admission) isolate each request's visible history. Freed slots are
    refilled from the queue at once. The KV caches live on the parameters'
    device and are updated in place. An admitted slot's SSM state (conv
    window and recurrent state) is zeroed: ``start`` hides a predecessor's
    KV entries, but nothing else would hide its recurrent state (the
    reference leaves it, ROADMAP R3).

    The requests carry token ids, so the vision and audio configs, whose
    inputs are embeddings from a front end that the reference stubs, are
    refused (ROADMAP R4); ``decode_step(embeds=)`` serves them directly.
    """

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int,
                 max_len: int):
        if cfg.modality in ("vision", "audio"):
            raise ValueError(
                f"{cfg.name}: ServeEngine's requests carry token ids, and the "
                f"{cfg.modality} config takes embeddings from a front end "
                "that is a stub in the reference; drive decode_step(params, "
                "cfg, None, state, embeds=...) directly")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = params["embed"]["table"].device
        self.step_fn = make_serve_step(cfg)
        self.caches = init_decode_state(cfg, slots, max_len,
                                        device=self.device)
        self.slot_req: list[Request | None] = [None] * slots
        self.prompt_pos = [0] * slots
        self.last_tok = [0] * slots
        self.queue: FifoQueue[Request] = FifoQueue()
        self.finished: list[Request] = []
        self.steps = 0

    def submit(self, req: Request) -> None:
        self.queue.push(req)

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.slot_req[s] is None and len(self.queue):
                self.slot_req[s] = self.queue.pop()
                self.prompt_pos[s] = 0
                # the new request must not see the slot's previous history:
                # its KV entries through start, its SSM state zeroed
                self.caches.start[s] = self.caches.length
                if self.caches.ssm is not None:
                    self.caches.ssm.conv[:, s].zero_()
                    self.caches.ssm.ssm[:, s].zero_()

    def _next_inputs(self) -> Tensor:
        toks = np.zeros((self.slots, 1), np.int32)
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            if self.prompt_pos[s] < len(req.prompt):
                toks[s, 0] = int(req.prompt[self.prompt_pos[s]])
            else:
                toks[s, 0] = self.last_tok[s]
        return torch.as_tensor(toks, device=self.device)

    def run(self, max_steps: int = 1_000) -> list[Request]:
        for _ in range(max_steps):
            self._admit()
            if all(r is None for r in self.slot_req) and not len(self.queue):
                break
            if self.caches.length >= self.max_len - 1:
                break  # cache exhausted — production would re-allocate
            logits, self.caches = self.step_fn(self.params,
                                               self._next_inputs(),
                                               self.caches)
            self.steps += 1
            nxt = greedy_sample(logits).cpu().numpy().reshape(self.slots, -1)
            for s, req in enumerate(self.slot_req):
                if req is None:
                    continue
                if self.prompt_pos[s] < len(req.prompt):
                    self.prompt_pos[s] += 1
                    if self.prompt_pos[s] < len(req.prompt):
                        continue          # still prefilling
                tok = int(nxt[s, 0])
                req.generated.append(tok)
                self.last_tok[s] = tok
                if len(req.generated) >= req.max_new_tokens:
                    req.done = True
                    self.finished.append(req)
                    self.slot_req[s] = None
        return self.finished


# ---------------------------------------------------- KRR prediction serving

@dataclasses.dataclass
class KRRRequest:
    uid: int
    x: np.ndarray                 # (dim,) query point
    y_hat: float | None = None
    done: bool = False


class KRRServeEngine:
    """Synchronous micro-batching adapter over the async serve plane.

    Requests are queued on the host (``repro_torch.serve.FifoQueue``) and
    drained ``batch_size`` at a time into the engine's published
    ``ModelSlot`` snapshot: the same padded fixed-shape predict that
    ``AsyncServeEngine`` serves through (on the card, one K1 launch a
    micro-batch), and a ``publish`` of a refreshed model swaps in
    atomically between steps. With the model config's
    ``precision.serve_dtype`` set, each micro-batch is served quantized;
    the engine surfaces the active mode as ``self.serve_dtype``.
    """

    def __init__(self, model: Any, *, batch_size: int = 64):
        # ``model`` is a fitted repro_torch.api.SketchedKRR; publishing it
        # into the slot fails fast if it is unfitted
        self.model = model
        self._slot = ModelSlot(model)
        entry = self._slot.current()
        self.batch_size = -(-batch_size // entry.n_shards) * entry.n_shards
        self.serve_dtype: str | None = entry.serve_dtype
        self.queue: FifoQueue[KRRRequest] = FifoQueue()
        self.finished: list[KRRRequest] = []

    def submit(self, req: KRRRequest) -> None:
        """Queue one prediction request for the next micro-batches."""
        self.queue.push(req)

    def publish(self, model: Any) -> int:
        """Hot-swap a refreshed model into the slot; the next ``step``
        serves it. Returns the slot's new version."""
        self.model = model
        return self._slot.publish(model)

    def step(self) -> list[KRRRequest]:
        """Serve one micro-batch; returns the requests completed."""
        batch = self.queue.take(self.batch_size)
        if not batch:
            return []
        entry = self._slot.current()   # one snapshot per micro-batch
        X = np.stack([np.asarray(r.x) for r in batch])
        y = entry.predict_padded(X, self.batch_size)
        for r, val in zip(batch, y):
            r.y_hat = float(val)
            r.done = True
        self.finished.extend(batch)
        return batch

    def run(self, max_steps: int = 1_000) -> list[KRRRequest]:
        """Serve micro-batches until the queue drains (or ``max_steps``);
        returns every request finished over the engine's lifetime."""
        for _ in range(max_steps):
            if not len(self.queue):
                break
            self.step()
        return self.finished
