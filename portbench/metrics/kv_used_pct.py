"""Share of the device K/V positions the engine holds (decode slots,
staging rows, prefix rows) that held tokens, summed over the window's
iterations (EngineStats kv_used_tokens / kv_reserved_tokens)."""


def read(rec):
    c = rec["counters"]
    total = c.get("kv_reserved_tokens", 0)
    return 100.0 * c.get("kv_used_tokens", 0) / total if total else None
