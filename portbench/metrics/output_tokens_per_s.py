"""Output tokens per second: every token the client saw in the window,
first tokens included, over the window's seconds (host clock)."""
from portbench.harness import timeline


def read(rec):
    n = timeline.tokens_in(rec["requests"], rec["t_open"], rec["t_close"])
    return n / rec["window_s"]
