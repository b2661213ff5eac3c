"""Share of the window's model steps served by replaying their CUDA
graphs (EngineStats graph_steps / model_steps).  model_steps counts the
decode steps and the prefill chunks, the calls that go through the
engine's step graphs; whole-prompt prefills (``prefill_into_slot``,
``prefill_to_host``, ``prefill_bucketed``) are in neither count, so 100
says every decode step and chunk was replayed, not every model call."""


def read(rec):
    c = rec["counters"]
    n = c.get("model_steps", 0)
    return 100.0 * c.get("graph_steps", 0) / n if n else None
