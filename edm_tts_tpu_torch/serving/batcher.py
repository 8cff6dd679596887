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
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable


@dataclasses.dataclass
class Request:
    text: str
    speaker: str
    seed: int = 0
    gt_length: int | None = None


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
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- client side ------------------------------------------------------
    def submit(self, req: Request) -> Future:
        """Enqueue one request; the Future resolves to its waveform.
        Raises queue.Full when the server is saturated (backpressure)."""
        if self._closed.is_set():
            raise RuntimeError("batcher is closed")
        fut: Future = Future()
        self._q.put_nowait((req, fut, time.monotonic()))
        with self._stats_lock:
            self._stats["requests"] += 1
        return fut

    def stats(self) -> dict:
        """Operational counters: request/batch counts, failures, mean and
        max client-visible latency, current queue depth."""
        with self._stats_lock:
            s = dict(self._stats)
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
        self._q.put((None, None, None))
        self._worker.join(timeout=10)

    # -- worker side ------------------------------------------------------
    def _collect(self) -> list[tuple[Request, Future]]:
        """Block for the first request, then gather more until the batch
        window closes or the batch is full."""
        first = self._q.get()
        if first[0] is None:
            self._q.task_done()
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item[0] is None:
                # re-post the shutdown sentinel so the NEXT _collect (which
                # would otherwise block forever on the drained queue) sees it
                self._q.task_done()
                self._q.put((None, None, None))
                return batch
            batch.append(item)
        # backlog drain for length-aware chunking: take what is already
        # queued (non-blocking — the window above is the only wait)
        while len(batch) < self.max_batch * self.lookahead:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item[0] is None:
                self._q.task_done()
                self._q.put((None, None, None))
                break
            batch.append(item)
        return batch

    def _loop(self) -> None:
        while True:
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
                req = item[0]
                key = (req.speaker, req.seed, req.gt_length is not None)
                groups.setdefault(key, []).append(item)
            for (speaker, seed, has_gt), group in groups.items():
                # length-homogeneous chunks: sort by estimated length, then
                # cut max_batch slices — each chunk's canvas is set by its
                # own max, so short requests stop paying for long ones
                group.sort(
                    key=lambda it: it[0].gt_length
                    if it[0].gt_length is not None else len(it[0].text)
                )
                for lo in range(0, len(group), self.max_batch):
                    self._dispatch(
                        group[lo:lo + self.max_batch], speaker, seed, has_gt
                    )
            for _ in batch:
                self._q.task_done()

    def _dispatch(self, items, speaker, seed, has_gt) -> None:
        """One engine call for one length-homogeneous chunk."""
        reqs = [r for r, _, _ in items]
        futs = [f for _, f, _ in items]
        t0s = [t for _, _, t in items]
        kwargs = {"seed": seed}
        if has_gt:
            kwargs["gt_lengths"] = [r.gt_length for r in reqs]
        try:
            wavs = self._synth([r.text for r in reqs], speaker, **kwargs)
            now = time.monotonic()
            with self._stats_lock:
                self._stats["engine_calls"] += 1
                self._stats["batched_requests"] += len(reqs)
                self._stats["completed"] += len(reqs)
                for t0 in t0s:
                    lat = now - t0
                    self._stats["latency_s_sum"] += lat
                    self._stats["latency_s_max"] = max(
                        self._stats["latency_s_max"], lat
                    )
            for fut, wav in zip(futs, wavs):
                fut.set_result(wav)
        except Exception as e:  # noqa: BLE001 — fail the requests, not the server
            with self._stats_lock:
                self._stats["engine_calls"] += 1
                self._stats["batched_requests"] += len(reqs)
                self._stats["failed"] += len(reqs)
            for fut in futs:
                fut.set_exception(e)
