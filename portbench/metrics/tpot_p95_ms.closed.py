"""tpot_p95_ms as a per-layer reading, for cells whose tail over a
window's few dozen requests spreads too far between runs to hold an
end-to-end bound: ``tpot_p95_ms``'s own reader."""
from portbench.harness import spec

read = spec.load_reader("tpot_p95_ms")
