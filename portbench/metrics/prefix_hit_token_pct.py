"""Prompt tokens served from the prefix cache over prompt tokens admitted
in the window (hit tokens + tokens prefilled in chunks)."""


def read(rec):
    c = rec["counters"]
    hit = c.get("prefix_hit_tokens", 0)
    total = hit + c.get("chunked_prefill_tokens", 0)
    return 100.0 * hit / total if total else None
