"""Dynamic request batching (copy of edm_tts_tpu/serving/batcher.py).

Throughput comes from batch: a batched engine call pays one pass of the
pipeline for several utterances, while batch-1 calls pay the whole latency
per utterance. This batcher turns independent requests into batched engine
calls: a worker thread collects requests for up to ``max_wait_ms`` (or
until ``max_batch``), groups them by speaker, seed and whether they carry a
length (one prompt and one seed per engine call), and resolves each
request's Future with its own trimmed waveform. When a backlog exists it
also drains up to ``max_batch * lookahead`` queued requests and cuts
length-sorted chunks, so short utterances stop riding long canvases.

Dependency-free (threading + futures): the single worker serializes
device access, so one program runs on the card at a time. Backpressure is
a bounded queue; ``submit`` raises when it is full. The grouping and
chunking are pinned equal to the JAX package's by
tests/test_torch_serving.py.

Each request is stamped three times on the ``perf_counter`` clock: when it
is submitted, when the worker takes it from the queue, and when its engine
call starts. ``stats()`` gives the tails of the phases between them over
the last ``TAIL_WINDOW`` completed requests; while ``utils.profiling``
records, each request's phases are the spans ``batcher.queued`` (submit to
taken) and ``batcher.held`` (taken to its call), the worker's wait for work
is ``batcher.collect`` and each engine call ``batcher.call``, which holds
the call's request ids and is the parent of the engine's spans.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable

from edm_tts_tpu_torch.utils.profiling import add_span, span

TAIL_WINDOW = 1024  # completed requests the tails of ``stats()`` cover


@dataclasses.dataclass
class Request:
    text: str
    speaker: str
    seed: int = 0
    gt_length: int | None = None


@dataclasses.dataclass
class _Pending:
    """A queued request, its Future, its id and its stamps."""
    req: Request
    fut: Future
    rid: int
    submitted: float
    taken: float = 0.0


def _nearest_rank(values: list[float], q: float) -> float:
    return sorted(values)[max(0, -(-len(values) * q // 100) - 1)] if values else 0.0


class DynamicBatcher:
    def __init__(
        self,
        synth_fn: Callable[..., list[Any]],
        *,
        max_batch: int = 16,
        max_wait_ms: float = 25.0,
        max_queue: int = 256,
        lookahead: int = 4,
    ):
        """synth_fn(texts, speaker, seed=..., gt_lengths=...) -> list of
        waveforms, one per text — e.g. ``TTSEngine.synthesize``.

        ``lookahead``: length-aware batch formation. The engine pads every
        row of a batch to the batch max (TTSEngine.synthesize), so a mixed
        batch wastes canvas on its short rows. When a backlog exists, the worker
        drains up to ``max_batch * lookahead`` ALREADY-QUEUED requests
        (never waits beyond ``max_wait_ms``), sorts them by estimated
        length (explicit gt_length, else text length as the proxy), and
        cuts length-homogeneous ``max_batch`` chunks. Under light load the
        queue never holds more than one batch and behavior is identical to
        ``lookahead=1``."""
        self._synth = synth_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.lookahead = max(1, lookahead)
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._closed = threading.Event()
        self._stats_lock = threading.Lock()
        self._stats = {
            "requests": 0, "completed": 0, "failed": 0,
            "engine_calls": 0, "batched_requests": 0,
            "latency_s_sum": 0.0, "latency_s_max": 0.0,
        }
        # (queued, held, latency) seconds of the last completed requests
        self._phases: collections.deque = collections.deque(maxlen=TAIL_WINDOW)
        self._ids = itertools.count()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- client side ------------------------------------------------------
    def submit(self, req: Request) -> Future:
        """Enqueue one request; the Future resolves to its waveform.
        Raises queue.Full when the server is saturated (backpressure)."""
        if self._closed.is_set():
            raise RuntimeError("batcher is closed")
        fut: Future = Future()
        self._q.put_nowait(_Pending(req, fut, next(self._ids), time.perf_counter()))
        with self._stats_lock:
            self._stats["requests"] += 1
        return fut

    def stats(self) -> dict:
        """Operational counters: request/batch counts, failures, mean and
        max client-visible latency, current queue depth; and over the last
        ``TAIL_WINDOW`` completed requests the p50 and p95 (nearest rank) of
        the seconds each spent queued (submit to the worker taking it),
        held (taken to the start of its engine call) and in all (submit to
        its call's end): ``queued_s_p50`` ... ``latency_s_p95``."""
        with self._stats_lock:
            s = dict(self._stats)
            phases = list(self._phases)
        for i, name in enumerate(("queued", "held", "latency")):
            values = [p[i] for p in phases]
            for q in (50, 95):
                s[f"{name}_s_p{q}"] = _nearest_rank(values, q)
        s["queue_depth"] = self._q.qsize()
        s["mean_batch"] = (
            s["batched_requests"] / s["engine_calls"]
            if s["engine_calls"] else 0.0
        )
        s["latency_s_mean"] = (
            s.pop("latency_s_sum") / s["completed"] if s["completed"] else 0.0
        )
        return s

    def close(self, drain: bool = True) -> None:
        """Stop accepting requests; optionally wait for in-flight work."""
        self._closed.set()
        if drain:
            self._q.join()
        # wake the worker if it is blocked on an empty queue
        self._q.put(None)
        self._worker.join(timeout=10)

    # -- worker side ------------------------------------------------------
    def _take(self, item: _Pending | None, batch: list[_Pending]) -> bool:
        """Stamp ``item`` and add it to ``batch``; False for the shutdown
        sentinel."""
        if item is None:
            return False
        item.taken = time.perf_counter()
        batch.append(item)
        return True

    def _collect(self) -> list[_Pending]:
        """Block for the first request, then gather more until the batch
        window closes or the batch is full."""
        batch: list[_Pending] = []
        if not self._take(self._q.get(), batch):
            self._q.task_done()
            return []
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if not self._take(item, batch):
                # re-post the shutdown sentinel so the NEXT _collect (which
                # would otherwise block forever on the drained queue) sees it
                self._q.task_done()
                self._q.put(None)
                return batch
        # backlog drain for length-aware chunking: take what is already
        # queued (non-blocking — the window above is the only wait)
        while len(batch) < self.max_batch * self.lookahead:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if not self._take(item, batch):
                self._q.task_done()
                self._q.put(None)
                break
        return batch

    def _loop(self) -> None:
        while True:
            with span("batcher.collect"):
                batch = self._collect()
            if not batch:
                if self._closed.is_set():
                    return
                continue
            # one engine call per (speaker, seed, has-gt-length) group: a
            # batch shares one prompt and one PRNG key, and gt_lengths is
            # all-or-nothing per engine call — splitting on it keeps a mixed
            # batch from silently discarding a request's explicit length
            groups: dict[tuple[str, int, bool], list] = {}
            for item in batch:
                req = item.req
                key = (req.speaker, req.seed, req.gt_length is not None)
                groups.setdefault(key, []).append(item)
            for (speaker, seed, has_gt), group in groups.items():
                # length-homogeneous chunks: sort by estimated length, then
                # cut max_batch slices — each chunk's canvas is set by its
                # own max, so short requests stop paying for long ones
                group.sort(
                    key=lambda it: it.req.gt_length
                    if it.req.gt_length is not None else len(it.req.text)
                )
                for lo in range(0, len(group), self.max_batch):
                    self._dispatch(
                        group[lo:lo + self.max_batch], speaker, seed, has_gt
                    )
            for _ in batch:
                self._q.task_done()

    def _dispatch(self, items: list[_Pending], speaker, seed, has_gt) -> None:
        """One engine call for one length-homogeneous chunk."""
        reqs = [it.req for it in items]
        futs = [it.fut for it in items]
        kwargs = {"seed": seed}
        if has_gt:
            kwargs["gt_lengths"] = [r.gt_length for r in reqs]
        try:
            with span("batcher.call", requests=[it.rid for it in items]) as s:
                start = time.perf_counter() if s is None else s.start
                for it in items:
                    add_span("batcher.queued", it.submitted, it.taken, requests=(it.rid,))
                    add_span("batcher.held", it.taken, start, requests=(it.rid,))
                wavs = self._synth([r.text for r in reqs], speaker, **kwargs)
            now = time.perf_counter()
            with self._stats_lock:
                self._stats["engine_calls"] += 1
                self._stats["batched_requests"] += len(reqs)
                self._stats["completed"] += len(reqs)
                for it in items:
                    lat = now - it.submitted
                    self._stats["latency_s_sum"] += lat
                    self._stats["latency_s_max"] = max(
                        self._stats["latency_s_max"], lat
                    )
                    self._phases.append((it.taken - it.submitted, start - it.taken, lat))
            for fut, wav in zip(futs, wavs):
                fut.set_result(wav)
        except Exception as e:  # noqa: BLE001 — fail the requests, not the server
            with self._stats_lock:
                self._stats["engine_calls"] += 1
                self._stats["batched_requests"] += len(reqs)
                self._stats["failed"] += len(reqs)
            for fut in futs:
                fut.set_exception(e)
