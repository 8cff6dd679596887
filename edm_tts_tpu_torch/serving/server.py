"""HTTP front end for the TTS engine: stdlib-only REST serving (port of
edm_tts_tpu/serving/server.py).

A ``ThreadingHTTPServer`` accepts concurrent requests; each handler thread
submits to the shared :class:`DynamicBatcher` and blocks on its Future, so
concurrent clients are coalesced into batched engine calls on the card.

Endpoints:
  POST /synthesize   {"text", "speaker", "seed"?, "gt_length"?,
                      "long"?, "max_chunk_chars"?, "crossfade_ms"?,
                      "gap_ms"?}
                     -> 200 audio/wav (16-bit PCM)
                     "long": true chunks arbitrarily long text at sentence
                     boundaries (serving/chunking.py); the chunks go through
                     the shared batcher as individual requests, so chunks of
                     one document and concurrent short requests coalesce
                     into the same batched engine calls.
  POST /speakers     {"name", "pcm_b64" (little-endian f32), "sample_rate"}
                     -> 200 {"ok": true} once the engine has tokenized the
                     prompt (``TTSEngine.register_speaker``); a missing field,
                     an empty PCM or an engine without a semantic tokenizer
                     -> 400 with the error's text.
  GET  /healthz      -> {"ok": true, "speakers": [...]}
  GET  /stats        -> batcher counters (latency, batch sizes, queue depth)
                     and, over the last 1,024 completed requests, the p50
                     and p95 seconds queued, held for their engine call and
                     in all (``DynamicBatcher.stats``)

Error mapping: unknown speaker / bad JSON -> 400, saturated queue -> 503
(backpressure), synthesis failure -> 500 with the exception text.
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from edm_tts_tpu_torch.serving.batcher import DynamicBatcher, Request
from edm_tts_tpu_torch.serving.chunking import default_chunk_chars, join_waveforms, split_text
from edm_tts_tpu_torch.serving.engine import TTSEngine


class TTSServer:
    def __init__(
        self,
        engine: TTSEngine,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        request_timeout_s: float = 600.0,
        **batcher_opts,
    ):
        self.engine = engine
        self.batcher = DynamicBatcher(engine.synthesize, **batcher_opts)
        self.request_timeout_s = request_timeout_s
        server = self

        class Handler(BaseHTTPRequestHandler):
            # quiet: route logs through nothing (servers log via /stats)
            def log_message(self, fmt, *args):  # noqa: D102
                pass

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    self._json(
                        200, {"ok": True, "speakers": server.engine.speakers()}
                    )
                elif self.path == "/stats":
                    self._json(200, server.batcher.stats())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802
                try:
                    body = self._body()
                except (ValueError, json.JSONDecodeError):
                    return self._json(400, {"error": "invalid JSON"})
                if self.path == "/synthesize":
                    return self._synthesize(body)
                if self.path == "/speakers":
                    return self._register(body)
                self._json(404, {"error": "not found"})

            def _register(self, body):
                try:
                    pcm = np.frombuffer(
                        base64.b64decode(body["pcm_b64"]), dtype="<f4"
                    )
                    server.engine.register_speaker(
                        body["name"], pcm, int(body["sample_rate"])
                    )
                except (KeyError, ValueError) as e:
                    return self._json(400, {"error": str(e)})
                self._json(200, {"ok": True})

            def _synthesize(self, body):
                if "text" not in body or "speaker" not in body:
                    return self._json(
                        400, {"error": "text and speaker are required"}
                    )
                if not isinstance(body["text"], str):
                    return self._json(400, {"error": "text must be a string"})
                if body["speaker"] not in server.engine.speakers():
                    return self._json(
                        400, {"error": f"unknown speaker {body['speaker']!r}"}
                    )
                if body.get("long"):
                    return self._synthesize_long(body)
                req = Request(
                    text=body["text"],
                    speaker=body["speaker"],
                    seed=int(body.get("seed", 0)),
                    gt_length=(
                        int(body["gt_length"])
                        if body.get("gt_length") is not None else None
                    ),
                )
                try:
                    fut = server.batcher.submit(req)
                except queue.Full:
                    return self._json(503, {"error": "server saturated"})
                except RuntimeError as e:
                    return self._json(503, {"error": str(e)})
                try:
                    wav = fut.result(timeout=server.request_timeout_s)
                except Exception as e:  # noqa: BLE001 — per-request failure
                    return self._json(500, {"error": str(e)})
                self._send_wav(wav)

            def _synthesize_long(self, body):
                if body.get("gt_length") is not None:
                    return self._json(400, {
                        "error": "gt_length is per-utterance; it cannot "
                        "apply to a chunked long request"
                    })
                try:
                    # explicit None test: a client's max_chunk_chars: 0 must
                    # reach split_text (which rejects it with 400), not be
                    # silently replaced by the default
                    max_chars = (
                        int(body["max_chunk_chars"])
                        if body.get("max_chunk_chars") is not None
                        else default_chunk_chars(server.engine.max_speech_len)
                    )
                    seed = int(body.get("seed", 0))
                    crossfade_ms = float(body.get("crossfade_ms", 30.0))
                    gap_ms = float(body.get("gap_ms", 0.0))
                    chunks = split_text(body["text"], max_chars)
                except (TypeError, ValueError) as e:
                    return self._json(400, {"error": str(e)})
                futs = []
                try:
                    for c in chunks:
                        futs.append(server.batcher.submit(
                            Request(text=c, speaker=body["speaker"],
                                    seed=seed)
                        ))
                except (queue.Full, RuntimeError) as e:
                    # already-submitted chunks complete and are discarded
                    return self._json(503, {"error": str(e) or "saturated"})
                # one deadline for the WHOLE long request: waiting each chunk
                # with a fresh timeout would bound worst-case wall time at
                # n_chunks x timeout instead of one request budget
                deadline = time.monotonic() + server.request_timeout_s
                try:
                    wavs = [
                        f.result(timeout=max(0.0, deadline - time.monotonic()))
                        for f in futs
                    ]
                except Exception as e:  # noqa: BLE001 — per-request failure
                    return self._json(500, {"error": str(e)})
                self._send_wav(join_waveforms(
                    wavs, server.engine.sample_rate,
                    crossfade_ms=crossfade_ms, gap_ms=gap_ms,
                ))

            def _send_wav(self, wav):
                from scipy.io import wavfile

                buf = io.BytesIO()
                pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
                wavfile.write(buf, server.engine.sample_rate, pcm)
                data = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    def start(self) -> "TTSServer":
        """Serve on a background thread (returns immediately)."""
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.batcher.close(drain=False)
