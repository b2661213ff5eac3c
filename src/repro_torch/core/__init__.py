"""APEX core of the port: analytical model (§3.2), analytic perf model
(§3.1), Algorithm 1, and the Asynchronous Overlap runtime (§3.3, §4.2)."""
