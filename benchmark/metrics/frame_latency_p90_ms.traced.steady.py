"""frame_latency_p90_ms.traced in the steady cell, read as
metrics/frame_latency_p90_ms.traced.py reads it; there it moves setup_s
(PERF.md section 2)."""
from slambench.manifest import load_reader

read = load_reader("frame_latency_p90_ms.traced")
