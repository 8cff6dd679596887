"""Seconds of audio returned in the window over the window's seconds: all
the calls that started in it, the window closing when the last returns.
Host clock."""


def read(run):
    if not run.requests:
        return None
    done = [r["audio_s"] for r in run.requests if r["done"] is not None]
    return sum(done) / run.window_s
