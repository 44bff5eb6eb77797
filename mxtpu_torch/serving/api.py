"""Request objects and error surface for the serving engine.

Port of ``mxtpu/serving/api.py``. A
:class:`ServingRequest` is the handle ``ServingEngine.submit()`` returns:
the caller blocks on :meth:`ServingRequest.result` or calls
:meth:`ServingRequest.cancel`. Cross-thread state lives behind the
request's own condition variable; the scheduler thread delivers tokens and
terminal states, submitters only read.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

__all__ = ["ServingRequest", "SamplingParams", "ServingConfig",
           "QueueFullError", "RequestCancelled", "DeadlineExceeded",
           "ShedError", "HandoffMismatch", "TIERS",
           "PENDING", "RUNNING", "DONE", "CANCELLED", "EXPIRED", "SHED"]

PENDING = "pending"        # in the admission queue, not yet prefilled
RUNNING = "running"        # prefilling or occupying a decode slot
DONE = "done"              # every requested token delivered
CANCELLED = "cancelled"    # caller cancelled (or the engine shut down)
EXPIRED = "expired"        # deadline passed before completion
SHED = "shed"              # the SLO scheduler shed it before its deadline

_TERMINAL = frozenset({DONE, CANCELLED, EXPIRED, SHED})

# priority tiers of the SLO scheduler (mxtpu_torch.sched.policy), most to
# least latency-sensitive; a request's tier is fixed for its lifetime
TIERS = ("interactive", "standard", "batch")


class QueueFullError(RuntimeError):
    """Admission queue at capacity — the submit was rejected, not queued."""


class ShedError(RuntimeError):
    """The SLO scheduler shed this request under overload: the measured
    service rates predicted its deadline unmeetable, so it was rejected
    early, before it took a prefill cursor or a decode slot and before the
    deadline passed. Distinct from :exc:`QueueFullError` (queue capacity)
    and :exc:`DeadlineExceeded` (the deadline really passed)."""


class HandoffMismatch(ValueError):
    """``adopt()`` of a ``ServingHandoff`` the adopting engine cannot take
    (another KV storage or geometry, drafts without speculative decode,
    parked requests without the SLO scheduler), raised before any page is
    installed."""


class RequestCancelled(RuntimeError):
    """result() on a request that was cancelled before completing."""


class DeadlineExceeded(RuntimeError):
    """result() on a request whose deadline passed before completing."""


_ids = itertools.count()


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling: ``temperature == 0`` (the default) is greedy
    argmax; ``temperature > 0`` samples the scaled, top-k-masked logits
    (``top_k <= 0`` disables truncation), deterministically per
    (seed, position)."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0 (0 = greedy)")
        if self.seed < 0:
            raise ValueError("seed must be >= 0")


@dataclass(frozen=True)
class ServingConfig:
    """Engine configuration as one value (``ServingEngine(config=...)``);
    an explicit constructor argument wins over the field, and ``None``
    fields take the engine's default. ``kv_dtype`` is the float cache's
    storage dtype name (e.g. ``'bfloat16'``); ``quant`` a token string
    (``'int8_kv'``, ``'fp8_kv'``, ``'int8_w'``, comma-joined) or a
    ``QuantSpec``; ``spec`` a ``SpecConfig`` or an integer draft depth
    (speculative decode, off when None). ``stall_deadline_s`` arms the
    engine's watchdog; ``sched`` installs the SLO scheduler (``True``, an
    ``SLOPolicy`` or an ``SLOScheduler``); ``prefill_batch`` (> 1, with
    ``sched`` only) packs that many pending prompts into one batched
    prefill program; ``engine_id`` names the engine in the stats and
    ``load()``. ``decode_kernel`` and ``mesh`` are fields of the reference
    the port does not take: a value other than None raises
    ``NotImplementedError``."""
    slots: Optional[int] = None
    queue_depth: Optional[int] = None
    chunk: Optional[int] = None
    prefill_chunk: Optional[int] = None
    prefix_cache_mb: Optional[float] = None
    stall_deadline_s: Optional[float] = None
    kv_dtype: Optional[str] = None
    quant: object = None
    decode_kernel: Optional[str] = None
    sched: object = None
    prefill_batch: Optional[int] = None
    spec: object = None
    mesh: object = None
    engine_id: Optional[str] = None


class ServingRequest:
    """One in-flight generation request: ``prompt`` token ids, ``max_new``
    tokens to generate, an optional ``deadline_s`` measured from submit
    (the request retires as :data:`EXPIRED` at the first step boundary past
    it, keeping its partial tokens), optional :class:`SamplingParams`, and
    ``prefix_cache=False`` to opt out of shared-prefix KV reuse both
    ways. ``tenant`` names the submitting tenant (the fair-share and
    per-tenant stats key) and ``priority`` its latency tier (one of
    :data:`TIERS`); both are inert without the SLO scheduler.

    ``forced`` are tokens the request already generated elsewhere (a
    continuation that a router re-routed from a removed replica): the
    engine feeds them after the prompt as if it had sampled them, through
    the same prefill and decode steps that first computed them, so their
    K/V rows come out bit for bit as they were, and delivers only the
    ``max_new`` tokens after them."""

    def __init__(self, prompt, max_new: int,
                 deadline_s: Optional[float] = None,
                 sampling: Optional[SamplingParams] = None,
                 prefix_cache: bool = True,
                 tenant: str = "default", priority: str = "standard",
                 forced=None):
        self.id = next(_ids)
        self.prompt = [int(t) for t in prompt]
        if not self.prompt:
            raise ValueError("empty prompt (give a BOS token for "
                             "unconditional generation)")
        self.forced = [int(t) for t in forced or ()]
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        self.max_new = int(max_new)
        if sampling is not None and not isinstance(sampling, SamplingParams):
            sampling = SamplingParams(**dict(sampling))
        self.sampling = sampling
        self.use_prefix_cache = bool(prefix_cache)
        self.tenant = str(tenant)
        if priority not in TIERS:
            raise ValueError(f"priority must be one of {TIERS}, "
                             f"got {priority!r}")
        self.priority = priority
        self.t_submit = time.monotonic()
        self.deadline = None if deadline_s is None \
            else self.t_submit + float(deadline_s)
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.state = PENDING
        self.error: Optional[BaseException] = None
        self._tokens: List[int] = []
        self._cancel = False
        self._cond = threading.Condition()

    # -- caller side --------------------------------------------------------
    @property
    def first_new(self) -> int:
        """The position of the first token still to deliver: after the
        prompt and the forced tokens."""
        return len(self.prompt) + len(self.forced)

    @property
    def total(self) -> int:
        return self.first_new + self.max_new

    def done(self) -> bool:
        with self._cond:
            return self.state in _TERMINAL

    def cancel(self) -> None:
        """Ask the engine to drop this request at the next step boundary.
        Idempotent; a no-op once terminal."""
        with self._cond:
            self._cancel = True
            self._cond.notify_all()

    def tokens(self) -> List[int]:
        """Generated tokens delivered so far (prompt excluded)."""
        with self._cond:
            return list(self._tokens)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until terminal; returns the generated-token list. Raises
        :exc:`RequestCancelled` / :exc:`DeadlineExceeded` (partial tokens on
        ``.args[1]``), the :exc:`ShedError` or the engine's error for the
        other non-DONE terminals, and ``TimeoutError`` if ``timeout``
        elapses first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self.state not in _TERMINAL:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"request {self.id} not finished in {timeout}s")
                self._cond.wait(timeout=left)
            if self.state == DONE:
                return list(self._tokens)
            if self.error is not None:
                raise self.error
            if self.state == CANCELLED:
                raise RequestCancelled(
                    f"request {self.id} cancelled", list(self._tokens))
            raise DeadlineExceeded(
                f"request {self.id} missed its deadline", list(self._tokens))

    # -- engine (scheduler-thread) side -------------------------------------
    def _cancelled(self) -> bool:
        with self._cond:
            return self._cancel

    def _expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    def _emit(self, toks, now: float) -> int:
        """Deliver generated tokens (capped at ``max_new``); returns how
        many the request still wants."""
        with self._cond:
            fresh = [int(t) for t in toks[:self.max_new - len(self._tokens)]]
            if fresh and self.t_first_token is None:
                self.t_first_token = now
            self._tokens.extend(fresh)
            self._cond.notify_all()
            return self.max_new - len(self._tokens)

    def _finish(self, state: str, now: float,
                error: Optional[BaseException] = None) -> None:
        with self._cond:
            if self.state in _TERMINAL:
                return
            self.state = state
            self.error = error
            self.t_done = now
            n_tokens = len(self._tokens)
            self._cond.notify_all()
        # one line into the flight recorder's ring of finished requests
        # (outside _cond: the recorder has its own lock)
        from ..observability import flight
        flight.note_request({
            "id": self.id, "state": state,
            "prompt": len(self.prompt), "max_new": self.max_new,
            "tokens": n_tokens,
            "ttft_ms": None if self.t_first_token is None
            else round((self.t_first_token - self.t_submit) * 1e3, 3),
            "total_ms": round((now - self.t_submit) * 1e3, 3),
            "error": repr(error) if error is not None else None})

    def _set_state(self, state: str) -> None:
        with self._cond:
            if self.state not in _TERMINAL:
                self.state = state
