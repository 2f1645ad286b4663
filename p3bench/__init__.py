"""The p3bench benchmark of plonky25_torch (BENCHMARK.json)."""
