"""The share of the t2s canvas a row uses: over the untraced
``engine.synthesize`` spans, the sum of their ``t2s_used`` (over the real
rows, 4 + text bytes + speech frames) over the sum of their
``t2s_positions`` (the bucket's rows times ``Lt + 4 + max_speech_len``),
counted by the engine. None where the run recorded no spans. Program
counter."""

from portbench import spans


def read(run):
    calls = spans.named(run, "engine.synthesize")
    calls = spans.untraced(run, calls) if calls else []
    positions = sum(s.counts["t2s_positions"] for s in calls)
    if not positions:
        return None
    return 100.0 * sum(s.counts["t2s_used"] for s in calls) / positions
