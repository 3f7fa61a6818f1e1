"""Request / sequence lifecycle for the continuous-batching engine.

A ``Request`` is the user-facing handle: prompt, per-request sampling
params, streamed output tokens, and a state machine

    WAITING -> PREFILLING -> RUNNING -> FINISHED
       ^            |           |
       +-- preempt -+-----------+

Every engine iteration is one mixed forward, so there is no separate
prefill pass: an admitted request is PREFILLING while its
``num_computed_tokens`` cursor walks the known tokens in scheduler-sized
chunks (pages are allocated as the cursor advances), and becomes RUNNING
when the cursor reaches the end — the chunk that gets there also samples
the next token, after which the request contributes one decode token per
step.

Preemption sends a PREFILLING/RUNNING request back to WAITING: its page
refcounts are released and the cursor resets to 0, but the tokens it
already emitted are kept — on re-admission the engine *re-matches* the
prefix trie over ``prompt + emitted`` (pages this request committed before
eviction are usually still cached, so resume is a cache hit, not a
recompute), computes KV only for the unmatched tail, and sampling continues
exactly where it left off (``resume_key`` carries the per-request PRNG
stream across the eviction).

``Sequence`` is the scheduled unit: the slot index in the batch, the
sequence's page allocation, and its prefill target.  One request owns
exactly one sequence (beam/parallel sampling would fan a request out into
several; that is future work, see ROADMAP).

Lifecycle timestamps: every transition is stamped with ``time.perf_counter``
(``t_arrival`` -> ``t_admitted`` -> ``t_first_token`` -> ``t_finished``,
plus an append-only ``events`` log that also records preemptions and
resumes), and the derived latencies — TTFT, queue wait, end-to-end — are
exposed as properties.  One contract matters for correctness of the
numbers: the engine dispatches step N+1 before step N's sampled tokens are
read back (lagged harvest), so token timestamps — ``t_first_token`` in
particular — are taken at device-sync HARVEST time, when the token value
actually exists on the host, never at dispatch time.  A dispatch-time stamp
would antedate the token by up to a full step and make TTFT non-monotone
across queue positions.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from typing import Callable, Optional


class RequestState(enum.Enum):
    WAITING = "waiting"        # queued or preempted: no pages, no slot
    PREFILLING = "prefilling"  # in a slot; prompt chunks streaming in
    RUNNING = "running"        # prefill done, one decode token per step
    FINISHED = "finished"      # eos / length cap reached; slot + pages freed


class FinishReason(enum.Enum):
    EOS = "eos"
    LENGTH = "length"
    ABORTED = "aborted"    # explicit engine.cancel (client disconnect)
    TIMEOUT = "timeout"    # deadline_s exceeded (engine deadline sweep)
    SHED = "shed"          # max_queue_wait_s exceeded while WAITING under
                           # overload (scheduler admission control)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 => greedy
    eos_id: Optional[int] = None
    seed: int = 0
    # fault-tolerance / SLO knobs (None = unbounded, the legacy behavior):
    # ``deadline_s`` bounds the request's total wall-clock lifetime from
    # arrival — the engine's per-step deadline sweep drives an expired
    # request (queued OR mid-generation) to FINISHED/TIMEOUT and frees its
    # pages immediately.  ``max_queue_wait_s`` is the admission-control
    # budget: a WAITING request past it that the scheduler still cannot
    # admit is SHED (aborted without ever holding pages) so overload
    # degrades by dropping the stalest queue entries instead of growing
    # every request's latency without bound.  ``priority`` orders admission
    # and preemption (higher = admitted earlier, preempted later; ties keep
    # FIFO order — all-default workloads behave exactly as before).
    deadline_s: Optional[float] = None
    max_queue_wait_s: Optional[float] = None
    priority: int = 0


_req_ids = itertools.count()


def reserve_req_ids(upto: int) -> None:
    """Advance the global request-id counter past ``upto`` so requests
    rebuilt from a snapshot (which keep their original ids) can never
    collide with ids handed to new requests after a restore."""
    global _req_ids
    _req_ids = itertools.count(max(next(_req_ids), upto + 1))


@dataclasses.dataclass
class Request:
    prompt: list[int]
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # called with (request, token) as each token is produced
    on_token: Optional[Callable[["Request", int], None]] = None
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    state: RequestState = RequestState.WAITING
    output_tokens: list[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[FinishReason] = None
    # prefill cursor: tokens of ``known_tokens`` whose KV is in the pool.
    # Starts at the matched-prefix length when prefix sharing finds cached
    # pages at admission; advances chunk by chunk while PREFILLING; resets
    # to 0 on preemption (re-matched, not recomputed, on resume).
    num_computed_tokens: int = 0
    # tokens served from shared prefix pages at the LAST admission (stats;
    # also the device write-mask fork point while this admission lives)
    num_cached_tokens: int = 0
    num_preemptions: int = 0
    # per-request PRNG stream captured at preemption ((2,) uint32), so a
    # resumed sampled request draws the same continuation it would have
    resume_key: Optional[object] = None
    # iteration indices, for per-request latency accounting
    arrived_step: int = -1
    admitted_step: int = -1
    finished_step: int = -1
    # wall-clock lifecycle stamps (time.perf_counter; -1.0 = not reached).
    # Token stamps are taken at device-sync harvest time — see module
    # docstring — so TTFT/ITL reflect when the token value reached the host.
    t_arrival: float = -1.0
    t_enqueued: float = -1.0     # arrival, re-stamped on preemption (the
                                 # queue-wait clock restarts for a victim)
    t_admitted: float = -1.0     # first admission only
    t_first_token: float = -1.0
    t_last_token: float = -1.0
    t_finished: float = -1.0
    # append-only (event, perf_counter) log: arrived / admitted / resumed /
    # first_token / preempted / finished
    events: list = dataclasses.field(default_factory=list)

    def mark(self, event: str, t: Optional[float] = None) -> float:
        """Stamp a lifecycle event into the log; returns the timestamp."""
        if t is None:
            t = time.perf_counter()
        self.events.append((event, t))
        return t

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (seconds), None until the token lands."""
        if self.t_first_token < 0 or self.t_arrival < 0:
            return None
        return self.t_first_token - self.t_arrival

    @property
    def queue_wait(self) -> Optional[float]:
        """Arrival -> first admission (seconds)."""
        if self.t_admitted < 0 or self.t_arrival < 0:
            return None
        return self.t_admitted - self.t_arrival

    @property
    def e2e_latency(self) -> Optional[float]:
        """Arrival -> finished (seconds)."""
        if self.t_finished < 0 or self.t_arrival < 0:
            return None
        return self.t_finished - self.t_arrival

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.output_tokens)

    @property
    def max_total_len(self) -> int:
        """Worst-case token footprint (page-reservation upper bound)."""
        return len(self.prompt) + self.sampling.max_new_tokens

    @property
    def known_tokens(self) -> list[int]:
        """Every token whose value is already known: the prompt plus tokens
        emitted before a preemption.  This is what PREFILLING (re)computes;
        the chunk that reaches its end samples the next new token."""
        return self.prompt + self.output_tokens

    def emit(self, token: int) -> None:
        self.output_tokens.append(token)
        if self.on_token is not None:
            self.on_token(self, token)

    def finish(self, reason: FinishReason, step: int,
               now: Optional[float] = None) -> None:
        self.state = RequestState.FINISHED
        self.finish_reason = reason
        self.finished_step = step
        self.t_finished = self.mark("finished", now)


@dataclasses.dataclass
class Sequence:
    """One scheduled sequence: slot + pages + prefill target.

    ``prefill_target`` is ``len(request.known_tokens)`` frozen at admission:
    the cursor position at which PREFILLING flips to RUNNING.  The write
    cursor itself lives on the request (``num_computed_tokens``) so it
    survives the sequence being torn down by preemption.
    """

    request: Request
    slot: int
    page_ids: list[int]    # physical pages, in logical order
    prefill_target: int    # known tokens to (re)compute before decoding
    admit_order: int = 0   # monotonic admission stamp: lower = higher priority
    t_admitted: float = -1.0   # when THIS sequence entered its slot (a
                               # resumed request gets a fresh sequence, so
                               # this is per-admission, unlike the request's)

    @property
    def req_id(self) -> int:
        return self.request.req_id

    @property
    def num_computed(self) -> int:
        """Tokens whose KV is in the pool == the next device write position."""
        return self.request.num_computed_tokens

    @property
    def remaining_prefill(self) -> int:
        return max(0, self.prefill_target - self.num_computed)

    @property
    def length(self) -> int:
        """Live context tokens (cost models price attention against this)."""
        return self.num_computed


__all__ = ["Request", "RequestState", "FinishReason", "SamplingParams",
           "Sequence"]
