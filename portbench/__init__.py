"""portbench: the benchmark of bmsparse_tpu_torch on an NVIDIA H100 (see BENCHMARK.json and PERF.md)."""
