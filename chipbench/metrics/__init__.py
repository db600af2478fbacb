"""Per-layer metrics: one reader a metric, named as in BENCHMARK.json."""
