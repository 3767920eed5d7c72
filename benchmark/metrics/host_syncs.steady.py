"""host_syncs in the steady cell, read as metrics/host_syncs.py reads it. There it
moves setup_s, the steady cell's one timed end-to-end metric: the set-up
tracks frames 0-104 through the same layers, and tracked_fps spreads too
widely in that cell to be bounded (PERF.md section 2)."""
from slambench.manifest import load_reader

read = load_reader("host_syncs")
