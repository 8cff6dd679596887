"""Serve zero-shot TTS over HTTP from model directories (port of the root
serve.py).

    python -m edm_tts_tpu_torch.serve --codec_model DIR --t2s_model DIR \\
        --s2a_model DIR --hubert_model DIR --speaker alice=alice.flac --port 8000

Loads the models once (``TTSEngine.from_dirs``, in ``--dtype`` on
``--device``: the card by default, an error without one), registers the
``--speaker NAME=WAV`` prompts (WAV or FLAC) and serves ``/synthesize``
(WAV), ``/speakers``, ``/healthz`` and ``/stats`` with dynamic request
batching (``serving.server.TTSServer``); ``"long": true`` requests are
chunked at sentence boundaries and ride the same batches. SIGTERM (or
Ctrl-C) shuts the server down and the process exits with code 0.
"""

from __future__ import annotations

import argparse
import signal
import threading

from edm_tts_tpu_torch.data.audio_io import load_audio
from edm_tts_tpu_torch.inference import DTYPES, add_model_args, device_of, print_launches
from edm_tts_tpu_torch.serving import TTSEngine, TTSServer


def build_server(args) -> TTSServer:
    """The engine from ``args``' model directories with its ``--speaker``
    prompts registered, behind a TTSServer (not started)."""
    engine = TTSEngine.from_dirs(
        args.codec_model, args.t2s_model, args.s2a_model, args.hubert_model,
        device=args.device, dtype=DTYPES[args.dtype],
        quantize=args.quantize, quantize_t2s=args.quantize_t2s,
        quantize_s2a=args.quantize_s2a, pred_iters=args.pred_iters,
        s2a_steps=args.s2a_steps, temperature=args.temperature,
        max_speech_len=args.max_speech_len,
    )
    for spec in args.speaker or []:
        name, path = spec.split("=", 1)
        audio, sr = load_audio(path)
        engine.register_speaker(name, audio[0], sr)
    return TTSServer(engine, host=args.host, port=args.port, max_batch=args.max_batch,
                     max_wait_ms=args.max_wait_ms, lookahead=args.batch_lookahead)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--speaker", action="append", metavar="NAME=WAV",
                    help="register a speaker prompt at startup (repeatable); more can be "
                         "added at runtime via POST /speakers")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max_batch", type=int, default=16)
    ap.add_argument("--max_wait_ms", type=float, default=25.0)
    # length-aware batch formation: drain up to max_batch * lookahead queued
    # requests, sort by estimated length, cut homogeneous chunks; 1 = off
    ap.add_argument("--batch_lookahead", type=int, default=4)
    add_model_args(ap)
    return ap


def main(argv: list[str] | None = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = device_of(ap, args.device)
    server = build_server(args)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    server.start()
    print(f"serving on http://{server.host}:{server.port} "
          f"(speakers: {server.engine.speakers()})", flush=True)
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    server.shutdown()
    print("shut down", flush=True)
    print_launches(device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
