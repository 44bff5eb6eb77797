"""Device-feed input pipeline — asynchronous host-to-device staging.

Port of ``mxtpu/device_feed.py``. A bounded producer thread pulls batches
from any ``DataIter`` or iterable and stages their dense leaves on the
device ``depth`` batches ahead of the consumer, so the consumer's next
inputs are already resident when it asks:

* **On the card** each leaf is copied into the next buffer of a ring of
  pinned host buffers, then to the device with a non-blocking copy on the
  feed's own copy stream; an event recorded behind the copy travels with
  the batch, and the consumer's stream waits on it (and the staged tensor
  is recorded on the consumer's stream) before the batch is handed out. A
  ring buffer is refilled only once the copy last made from it has run.
* **On the CPU** the same code path runs without a stream: the leaf is
  copied through the ring into a tensor of its own.

``device=None`` means the card, and raises without CUDA, as every entry
point of the port does. A delivered batch is never re-enqueued and the
feed keeps no reference to it; a producer exception is latched and raised
in the consumer; the producer owns its queue and stop flag, so a straggler
from before ``reset()`` never leaks a stale batch into the next epoch.

Knobs: ``MXTPU_DEVICE_FEED=0`` opts :func:`maybe_device_feed` out;
``MXTPU_FEED_DEPTH`` overrides the default depth of 2. Transfer and stall
accounting lands in ``profiler.get_feed_stats()``.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from . import profiler
from .context import resolve_device
from .io import DataBatch, DataIter
from .observability import tracer

__all__ = ["DeviceFeed", "feed_enabled", "default_depth", "maybe_device_feed"]


def feed_enabled() -> bool:
    """The ``MXTPU_DEVICE_FEED`` opt-out gate (read at call time)."""
    return os.environ.get("MXTPU_DEVICE_FEED", "1").lower() not in (
        "0", "false", "off")


def default_depth() -> int:
    """Prefetch depth: batches staged ahead of the consumer
    (``MXTPU_FEED_DEPTH``, default 2)."""
    try:
        return max(1, int(os.environ.get("MXTPU_FEED_DEPTH", "2")))
    except ValueError:
        return 2


def maybe_device_feed(data_iter, depth: Optional[int] = None, device=None):
    """Wrap ``data_iter`` in a :class:`DeviceFeed` unless the gate is off or
    it is one already; an iterator's ``device_feed_depth`` attribute sets
    the depth when ``depth`` is None."""
    if not feed_enabled() or isinstance(data_iter, DeviceFeed):
        return data_iter
    if depth is None:
        depth = getattr(data_iter, "device_feed_depth", None)
    return DeviceFeed(data_iter, depth=depth, device=device)


class _Generation:
    """One producer lifetime: the thread gets this object's queue and stop
    flag, so after ``reset()`` abandons it a straggler only ever sees its
    own."""

    __slots__ = ("queue", "stop", "thread", "error")

    def __init__(self, depth: int):
        self.queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def put(self, item) -> bool:
        """Stop-aware bounded put; False once this generation is
        abandoned."""
        while not self.stop.is_set():
            try:
                self.queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False


class _Staging:
    """The producer's ring of host buffers (pinned on the card) and, on the
    card, its copy stream. Owned by one producer thread."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._bufs: List[Optional[torch.Tensor]] = [None] * slots
        self._events: List[Optional[torch.cuda.Event]] = [None] * slots
        self._next = 0

    def stage(self, host: torch.Tensor):
        """``host`` through the next ring buffer onto the device; returns
        the staged tensor and, on the card, the event behind its copy."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()     # its last copy has run
        nbytes = host.numel() * host.element_size()
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            buf = self._bufs[i] = torch.empty(
                max(nbytes, 2 * (0 if buf is None else buf.numel()), 64),
                dtype=torch.uint8, pin_memory=self.cuda)
        view = buf[:nbytes].view(host.dtype).view(host.shape)
        view.copy_(host)
        if not self.cuda:
            return view.clone(), None
        with torch.cuda.stream(self.stream):
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            dev.copy_(view, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self._events[i] = ev
        return dev, ev


class DeviceFeed(DataIter):
    """Asynchronous device-resident prefetcher over any batch source.

    ``data_iter`` may be a ``DataIter`` (resettable, so usable across
    epochs) or any iterable of arrays, tuples or lists of arrays, or
    ``DataBatch``es (one pass). Dense leaves (numpy arrays, CPU tensors
    and NDArrays over them) are staged on ``device``, an NDArray as a new
    NDArray; tensors already there are handed through
    (counted as ``resident_skips``); anything else (a request handle, a
    scalar) passes through untouched."""

    def __init__(self, data_iter, depth: Optional[int] = None, device=None):
        super().__init__(getattr(data_iter, "batch_size", 0))
        self.device = resolve_device(device)
        self.iter = data_iter
        self.depth = max(1, int(depth)) if depth else default_depth()
        self._gen: Optional[_Generation] = None

    # -- staging (producer thread) ----------------------------------------
    def _place_arr(self, arr, staging: _Staging, events: list):
        from .ndarray.ndarray import NDArray
        if isinstance(arr, NDArray):     # a host batch's array handle
            placed = self._place_arr(arr.data, staging, events)
            return arr if placed is arr.data else NDArray(placed)
        if isinstance(arr, torch.Tensor) and arr.device == self.device:
            profiler.record_feed_resident()
            return arr
        if isinstance(arr, np.ndarray):
            host = torch.from_numpy(np.ascontiguousarray(arr))
        elif isinstance(arr, torch.Tensor) and arr.device.type == "cpu":
            host = arr.contiguous()
        else:
            return arr
        t0 = time.perf_counter()
        dev, ev = staging.stage(host)
        if ev is not None:
            events.append(ev)
        profiler.record_feed_transfer(host.numel() * host.element_size(),
                                      (time.perf_counter() - t0) * 1e3)
        return dev

    def _stage(self, batch, staging: _Staging):
        """One batch's dense leaves onto the device, its structure kept;
        returns ``(staged batch, events)``."""
        events: list = []
        place = lambda a: self._place_arr(a, staging, events)  # noqa: E731
        if isinstance(batch, DataBatch):
            label = [place(a) for a in batch.label] \
                if batch.label is not None else None
            out = DataBatch(
                data=[place(a) for a in (batch.data or [])],
                label=label, pad=batch.pad, index=batch.index,
                bucket_key=batch.bucket_key, provide_data=batch.provide_data,
                provide_label=batch.provide_label)
        elif isinstance(batch, (tuple, list)):
            out = type(batch)(place(a) for a in batch)
        else:
            out = place(batch)
        return out, events

    def _produce(self, gen: _Generation, src):
        from .resilience.faults import fault_point
        from .resilience.watchdog import heartbeat
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            staging = _Staging(self.device, self.depth + 2)
            while not gen.stop.is_set():
                try:
                    batch = next(src)
                except StopIteration:
                    break
                fault_point("feed.produce")
                heartbeat("feed")
                with tracer.span("feed/transfer", cat="feed"):
                    staged = self._stage(batch, staging)
                batch = None
                if not gen.put(("data", staged)):
                    return
                staged = None    # the consumer owns the batch now
                depth = gen.queue.qsize()
                profiler.record_feed_prefetch(depth)
                tracer.counter("feed/queue_depth", depth)
        except BaseException as e:  # latched: visible even if the put is lost
            gen.error = e
            gen.put(("error", e))
            return
        gen.put(("end", None))

    def _ensure(self) -> _Generation:
        if self._gen is None:
            gen = _Generation(self.depth)
            profiler.set_feed_depth(self.depth)
            gen.thread = threading.Thread(
                target=self._produce, args=(gen, iter(self.iter)),
                daemon=True, name="mxtpu-device-feed")
            gen.thread.start()
            self._gen = gen
        return self._gen

    # -- consumer ----------------------------------------------------------
    def _deliver(self, payload):
        """The consumer's stream waits for the batch's copies, and each
        staged tensor is recorded on it (the allocator then keeps its
        memory until the consumer's work on it has run)."""
        batch, events = payload
        if not events:
            return batch
        stream = torch.cuda.current_stream(self.device)
        for ev in events:
            stream.wait_event(ev)
        if isinstance(batch, DataBatch):
            leaves = list(batch.data) + list(batch.label or [])
        elif isinstance(batch, (tuple, list)):
            leaves = batch
        else:
            leaves = [batch]
        for t in leaves:
            t = getattr(t, "_data", t)          # an NDArray's tensor
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(stream)
        return batch

    def next(self):
        gen = self._ensure()
        t0 = time.perf_counter()
        with tracer.span("feed/stall", cat="feed"):
            while True:
                try:
                    kind, payload = gen.queue.get(timeout=0.1)
                    break
                except queue.Empty:
                    if gen.error is not None:
                        raise gen.error
                    if gen.thread is not None and not gen.thread.is_alive():
                        raise RuntimeError(
                            "DeviceFeed producer thread died without "
                            "delivering a batch or an exception")
        stall_ms = (time.perf_counter() - t0) * 1e3
        if kind == "error":
            raise payload
        if kind == "end":
            raise StopIteration
        profiler.record_feed_consume(stall_ms)
        return self._deliver(payload)

    def poll(self, timeout: float = 0.0):
        """Non-blocking consumer: the next staged batch if one is ready
        within ``timeout`` seconds, else ``None``; producer errors raise and
        the end of the stream raises ``StopIteration``, as in :meth:`next`.
        The serving engine's admission path."""
        gen = self._ensure()
        t0 = time.perf_counter()
        try:
            if timeout > 0:
                kind, payload = gen.queue.get(timeout=timeout)
            else:
                kind, payload = gen.queue.get_nowait()
        except queue.Empty:
            if gen.error is not None:
                raise gen.error
            return None
        if kind == "error":
            raise payload
        if kind == "end":
            raise StopIteration
        profiler.record_feed_consume((time.perf_counter() - t0) * 1e3)
        return self._deliver(payload)

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        """Stop the current producer and drop its queue (the staged batches
        go with it)."""
        gen, self._gen = self._gen, None
        if gen is None:
            return
        gen.stop.set()
        try:  # wake a put blocked on a full queue
            gen.queue.get_nowait()
        except queue.Empty:
            pass
        if gen.thread is not None:
            gen.thread.join(timeout=10)

    def reset(self):
        self.close()
        inner_reset = getattr(self.iter, "reset", None)
        if inner_reset is None:
            raise RuntimeError(
                "DeviceFeed wraps a single-pass iterable (no reset()); "
                "wrap a resettable DataIter for multi-epoch use")
        inner_reset()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label
