"""The benchmark's harness: cells read from ``BENCHMARK.json``, each
configuration, traffic mix, limit set and metric a file of its own under
``perfbench/``, found by name."""
