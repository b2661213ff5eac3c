"""Share of the window's decode tokens that host rows emitted
(EngineStats host_tokens / (device_tokens + host_tokens))."""


def read(rec):
    c = rec["counters"]
    total = c.get("device_tokens", 0) + c.get("host_tokens", 0)
    return 100.0 * c.get("host_tokens", 0) / total if total else None
