"""The benchmark of vec_vad_torch on NVIDIA GPUs (BENCHMARK.json): one
command runs one cell once (vadbench/run.py); configurations, cells,
drivers and per-layer metric readers are files found by name."""
