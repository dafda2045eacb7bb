"""The benchmark of acvae_tpu_torch: see BENCHMARK.json and PERF.md."""
