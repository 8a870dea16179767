"""The benchmark of pir_tpu_torch: see BENCHMARK.json and PERF.md."""
