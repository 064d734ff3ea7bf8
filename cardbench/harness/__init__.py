"""The benchmark's harness: traffic, loops, weights, tracing, metric arithmetic
and the correctness check.  Everything that belongs to one configuration,
traffic mix, per-layer metric or cell lives in data files and readers
beside it (``configs/``, ``traffic/``, ``metrics/``, ``limits/``), found by
the names in ``BENCHMARK.json``; a model family's weights, parameter count
and plain reference live in ``reference/<family>.py``, named by its
configuration file."""
