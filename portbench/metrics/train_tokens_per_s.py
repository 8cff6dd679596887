"""Sequence positions trained in the window over the window's seconds:
every optimizer step that started in it (batch x frames each), the window
closing when the last step's update is done. Host clock."""


def read(run):
    tokens = [c["tokens"] for c in run.calls if "tokens" in c]
    if not tokens:
        return None
    return sum(tokens) / run.window_s
