"""Continuous-batching scheduler for incremental spiking-LM decode (PyTorch
port of the JAX package's ``launch/scheduler.py``).

A decode step is cheap and its carried state small -- one O(d^2)-per-head
K^T V accumulator per layer, constant in context length -- so what limits
serving throughput is scheduling: the synchronous slot loop
(``launch.serve.serve_lm_plan``) admits nothing until the slowest member of a
batch finishes, and freed slots idle for the rest of it.

This module serves continuously, on the engine's decode entry points:

* **Admission queue and backpressure** (:class:`AdmissionQueue`): a bounded
  pending queue in front of the slots.  ``submit`` refuses work once the
  bound is hit; the policy says whether refused work is dropped
  (``"reject"``, counted against the service) or retried by the caller
  (``"defer"``).
* **Per-slot state paging**: an admitted prompt is prefilled at its own
  length (batch 1), and its decode state is copied into the freed slot of
  the one live batched ``DecodeState`` (``engine.decode_state_scatter``).
* **Ragged completion and eviction**: every slot tracks its own ``max_new``
  and optional EOS; finished sequences retire mid-flight and their slots
  refill on the next tick.  A retired slot keeps stepping with its last token
  and state until it refills; batch rows are independent, so that changes no
  other slot's tokens.

The decode step always runs the full ``slots``-wide batch: one step shape per
slot count, plus one prefill shape per distinct prompt length, however the
admissions interleave.  Greedy streams equal the single-stream decode's per
request wherever the head's f32 GEMM, whose sum order may depend on the row
count, leaves the argmax unchanged (a top-2 margin above ~1e-4).

**Decode-interleaved chunked admission** (``prefill_chunk=C``): an admitted
prompt advances one C-token resumable chunk (``engine.prefill_chunk``) per
scheduler tick, with decode steps between chunks, so the decode stall one
admission can cause is bounded by one chunk's latency, and the prefill shapes
are the chunk buckets (C and each distinct ragged tail).  Token streams equal
one-shot admission's: the chunk carry is exact integer arithmetic on spikes.

The port runs the ``make_*_fn`` functions directly (there is no ``jax.jit``);
each place where the reference blocks on a result reads it on the host
instead (``int(...)``, ``.cpu()``), so ``prefill_s``, ``decode_s`` and
``stall_s`` time the same work.  The port serves on one device: the data
degree is 1.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import engine

__all__ = ["greedy", "Request", "AdmissionQueue", "ContinuousScheduler"]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocabulary, as int64 (the embedding gather's index).
    ``launch.serve.greedy_sample`` is this function: the streams of both
    serving paths compare token ids, so they sample with one function."""
    return torch.argmax(logits, dim=-1)


@dataclass
class Request:
    """One decode request plus its service-time record.

    ``arrival_s`` is the open-loop arrival offset (seconds from the run start);
    the scheduler fills the rest: ``first_token_s`` is when the prefill's
    greedy token was ready (TTFT = ``first_token_s - arrival_s``) and
    ``finish_s`` when the last token was.  ``tokens`` holds Python ints.
    """

    rid: int
    prompt: np.ndarray                    # (S,) prompt token ids
    max_new: int = 16
    eos_id: int | None = None
    arrival_s: float = 0.0
    # filled in by the scheduler:
    tokens: list[int] = field(default_factory=list)
    admit_s: float | None = None
    first_token_s: float | None = None
    finish_s: float | None = None
    rejected: bool = False

    @property
    def prompt_len(self) -> int:
        return int(np.shape(self.prompt)[0])

    @property
    def done(self) -> bool:
        if len(self.tokens) >= self.max_new:
            return True
        return (self.eos_id is not None and len(self.tokens) > 0
                and self.tokens[-1] == self.eos_id)


class AdmissionQueue:
    """Bounded FIFO in front of the slots: the service's backpressure point.

    ``submit`` returns False once ``max_pending`` requests wait (the caller
    drops or retries per ``policy``); the high-water mark and the refusal
    count are the backpressure telemetry."""

    def __init__(self, max_pending: int = 64, policy: str = "reject"):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if policy not in ("reject", "defer"):
            raise ValueError(f"unknown admission policy: {policy!r}")
        self.max_pending = max_pending
        self.policy = policy
        self._q: deque[Request] = deque()
        self.submitted = 0
        self.refused = 0
        self.high_water = 0

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, req: Request) -> bool:
        if len(self._q) >= self.max_pending:
            self.refused += 1
            return False
        self._q.append(req)
        self.submitted += 1
        self.high_water = max(self.high_water, len(self._q))
        return True

    def pop(self) -> Request:
        return self._q.popleft()


def _chunk_buckets(prompt_len: int, chunk: int) -> set[int]:
    """The distinct chunk lengths a prompt prefills at under chunked admission:
    the full chunk size (if the prompt spans at least one) and its ragged tail
    (if any) -- the warm-shape bill of a prompt length."""
    full, ragged = divmod(prompt_len, chunk)
    out = set()
    if full:
        out.add(chunk)
    if ragged:
        out.add(ragged)
    return out


class ContinuousScheduler:
    """Continuous-batching decode service over one compiled LM deploy plan.

    The device side is three functions and one resident state: ``prefill``
    (one shape per prompt length, or ``prefill_chunk``, one per chunk bucket),
    ``decode_step`` (one shape: the full slot batch), and the
    ``decode_state_scatter`` admission paging, all on the single batched
    ``DecodeState`` that lives for the whole service.  Everything else is
    host bookkeeping.
    """

    def __init__(self, plan, *, slots: int = 4, max_pending: int = 64,
                 admission: str = "reject", prefill_chunk: int | None = None,
                 clock=time.perf_counter):
        meta = plan.meta
        if meta.decode is None:
            raise ValueError(
                "continuous batching is an LM-plan mode (needs the incremental "
                f"decode entry); family={meta.family!r}")
        self.plan = plan
        # the step batch shards over the mesh's data axis (1 on one device)
        self.data_par = (1 if meta.sharding is None
                         else meta.mesh.axis(meta.sharding.data_axis).size)
        if slots < 1 or slots % self.data_par:
            raise ValueError(f"slots={slots} must be a positive multiple of the mesh data "
                             f"degree {self.data_par} (the step batch shards over it)")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1 (tokens), got {prefill_chunk}")
        self.slots = slots
        self.queue = AdmissionQueue(max_pending, admission)
        self._clock = clock
        self._t0 = self._clock()                      # run() resets this
        self._prefill = engine.make_prefill_fn(plan)
        self._step = engine.make_decode_step_fn(plan)
        self._scatter = engine.decode_state_scatter
        self.prefill_chunk = prefill_chunk
        self._prefill_chunk = (engine.make_prefill_chunk_fn(plan)
                               if prefill_chunk is not None else None)
        # in-flight chunked admission: [request, running state, offset]
        self._partial: list | None = None
        self.state = engine.decode_state_batch_init(meta, slots)
        self._tok = np.zeros((slots,), np.int64)      # next feed per slot
        self._active: list[Request | None] = [None] * slots
        self._free: deque[int] = deque(range(slots))
        self.completed: list[Request] = []
        self.rejected: list[Request] = []
        # telemetry
        self.steps = 0
        self.admitted = 0
        self.active_slot_steps = 0                    # occupancy numerator
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.prefill_chunks = 0                       # chunk steps run
        self.stall_s: list[float] = []                # per-tick admission work

    @property
    def _device(self) -> torch.device:
        return self.plan.meta.device

    def _feed(self) -> torch.Tensor:
        """The per-slot next tokens on the plan's device (a copy: ``_tok``
        changes as the service goes on)."""
        return torch.tensor(self._tok, dtype=torch.long, device=self._device)

    # -- shape warming ----------------------------------------------------------

    def warm(self, prompt_lens) -> int:
        """Run every shape serving will touch once (on the card this also
        builds the kernels): one prefill and scatter per distinct prompt length
        -- or, under chunked admission, per distinct chunk bucket (the chunk
        size and each ragged tail), which no longer grows with the prompt
        lengths -- and one step for the slot batch.  Returns the number of
        prefill shapes warmed (lengths that bucket alike warm once)."""
        meta = self.plan.meta
        warmed = 0
        with torch.inference_mode():
            if self.prefill_chunk is None:
                for s in sorted({int(s) for s in prompt_lens}):
                    tokens = torch.zeros((self.data_par, s), dtype=torch.long,
                                         device=self._device)
                    _, st = self._prefill(self.plan.params, tokens)
                    scratch = engine.decode_state_batch_init(meta, self.slots)
                    int(self._scatter(scratch, 0, st, 0).pos[0])
                    warmed += 1
            else:
                buckets: set[int] = set()
                for s in {int(s) for s in prompt_lens}:
                    buckets |= _chunk_buckets(s, self.prefill_chunk)
                for c in sorted(buckets):
                    tokens = torch.zeros((self.data_par, c), dtype=torch.long,
                                         device=self._device)
                    st = engine.decode_state_init(meta, self.data_par)
                    _, st = self._prefill_chunk(self.plan.params, st, tokens)
                    scratch = engine.decode_state_batch_init(meta, self.slots)
                    int(self._scatter(scratch, 0, st, 0).pos[0])
                    warmed += 1
            greedy(self._step(self.plan.params, self.state, self._feed())[0]).cpu()
        return warmed

    # -- admission ----------------------------------------------------------------

    @property
    def num_active(self) -> int:
        return self.slots - len(self._free)

    def submit(self, req: Request) -> bool:
        """Offer a request to the admission queue (backpressure applies)."""
        ok = self.queue.submit(req)
        if not ok and self.queue.policy == "reject":
            req.rejected = True
            self.rejected.append(req)
        return ok

    def _pad_prompt_batch(self, prompt) -> torch.Tensor:
        """(S,) prompt -> (data_par, S) prefill batch on the plan's device: the
        prompt repeated on every data shard (rows past the first are dead
        weight the data axis requires)."""
        seq = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=self._device)[None]
        return seq.expand(self.data_par, -1)

    def _src_row(self, slot: int) -> int:
        """The row of a padded prefill batch to page into ``slot``: the copy
        on the slot's own data shard (every row holds the same prompt), so
        no state moves between ranks."""
        return slot // (self.slots // self.data_par)

    def _now(self) -> float:
        """Seconds since the current run started -- re-read at every stamp
        (admissions earlier in the same drain must show in later requests'
        ``admit_s``/``first_token_s``)."""
        return self._clock() - self._t0

    def _seat(self, req: Request, st, tok0: int) -> None:
        """Finish an admission whose prefill produced state ``st`` and first
        token ``tok0``: stamp TTFT off a fresh clock read, retire instantly
        done requests, otherwise page the state into a freed slot."""
        self.admitted += 1
        req.first_token_s = self._now()
        req.tokens.append(tok0)
        if req.done:                       # max_new == 1 (or instant EOS):
            req.finish_s = req.first_token_s   # never occupies a slot
            self.completed.append(req)
            return
        slot = self._free.popleft()
        self.state = self._scatter(self.state, slot, st, self._src_row(slot))
        self._tok[slot] = tok0
        self._active[slot] = req

    def _admit_one(self, req: Request) -> None:
        req.admit_s = self._now()
        t0 = self._clock()
        logits, st = self._prefill(self.plan.params, self._pad_prompt_batch(req.prompt))
        tok0 = int(greedy(logits[:, -1])[0])
        self.prefill_s += self._clock() - t0
        self._seat(req, st, tok0)

    def _advance_partial(self) -> None:
        """Chunked admission: advance the in-flight prompt by one resumable
        prefill chunk (starting a new one from the queue if a slot is free),
        then return to decode -- the decode stall per tick is bounded by one
        chunk's latency, whatever the prompt length."""
        if self._partial is None:
            if not (self._free and len(self.queue)):
                return
            req = self.queue.pop()
            req.admit_s = self._now()
            st = engine.decode_state_init(self.plan.meta, self.data_par)
            self._partial = [req, st, 0]
        req, st, off = self._partial
        tokens = req.prompt[off:off + self.prefill_chunk]
        t0 = self._clock()
        logits, st = self._prefill_chunk(self.plan.params, st, self._pad_prompt_batch(tokens))
        # the host read of pos waits for the chunk: on the device's stream it
        # is computed after every kv plane of the chunk
        int(st.pos)
        self.prefill_s += self._clock() - t0
        self.prefill_chunks += 1
        off += int(np.shape(tokens)[0])
        if off < req.prompt_len:
            self._partial = [req, st, off]
            return
        self._partial = None
        tok0 = int(greedy(logits[:, -1])[0])
        self._seat(req, st, tok0)

    def _admit(self) -> None:
        if self.prefill_chunk is not None:
            self._advance_partial()        # at most one chunk per tick
            return
        while self._free and len(self.queue):
            self._admit_one(self.queue.pop())

    # -- decode -------------------------------------------------------------------

    def _decode_tick(self) -> None:
        """One batched decode step and its harvest: every active slot appends
        its greedy token; finished requests retire and free their slot (the
        batch keeps stepping without them)."""
        t0 = self._clock()
        logits, self.state = self._step(self.plan.params, self.state, self._feed())
        nxt = greedy(logits).cpu().numpy()
        self.decode_s += self._clock() - t0
        self.steps += 1
        self.active_slot_steps += self.num_active
        done_s = self._now()
        for slot, req in enumerate(self._active):
            if req is None:
                continue
            tok = int(nxt[slot])
            req.tokens.append(tok)
            self._tok[slot] = tok
            if req.done:
                req.finish_s = done_s
                self._active[slot] = None
                self._free.append(slot)
                self.completed.append(req)

    # -- service loop -------------------------------------------------------------

    def run(self, requests=(), *, open_loop: bool = False) -> list[Request]:
        """Serve ``requests`` to completion (plus anything already pending).

        Closed loop (default): every request is available at once, in
        iteration order.  ``open_loop=True`` honours each request's
        ``arrival_s`` against the wall clock, so admission, backpressure and
        eviction interleave as live traffic would drive them.  Returns the
        completed requests (rejected ones accumulate on ``self.rejected``)."""
        arrivals = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        self._t0 = self._clock()
        with torch.inference_mode():
            while (arrivals or len(self.queue) or self.num_active
                   or self._partial is not None):
                now = self._now()
                while arrivals and (not open_loop or arrivals[0].arrival_s <= now):
                    req = arrivals[0]
                    if self.submit(req):
                        arrivals.popleft()
                    elif self.queue.policy == "reject":
                        arrivals.popleft()        # dropped: counted on .rejected
                    else:
                        break                     # defer: retry after the tick
                p0 = self.prefill_s
                self._admit()
                if self.prefill_s > p0:           # this tick's admission stall
                    self.stall_s.append(self.prefill_s - p0)
                if self.num_active:
                    self._decode_tick()
                elif (arrivals and open_loop and not len(self.queue)
                      and self._partial is None):
                    wait = arrivals[0].arrival_s - self._now()
                    if wait > 0:
                        time.sleep(min(wait, 1e-3))
        return self.completed

    def stats(self) -> dict:
        """Service telemetry: steps, admissions, slot occupancy, queue
        backpressure, and the host time spent in prefill and decode."""
        denom = self.steps * self.slots
        return {
            "slots": self.slots,
            "steps": self.steps,
            "admitted": self.admitted,
            "completed": len(self.completed),
            "rejected": len(self.rejected),
            "queue_refused": self.queue.refused,
            "queue_high_water": self.queue.high_water,
            "slot_occupancy": (self.active_slot_steps / denom if denom else 0.0),
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "new_tokens": sum(len(r.tokens) for r in self.completed),
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunks": self.prefill_chunks,
        }
