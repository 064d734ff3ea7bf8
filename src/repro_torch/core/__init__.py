"""Host core: copies of the numpy modules of src/repro/core that the engine
needs (trees, otlp, traversal, univer, greedy_bv, verify, delayed,
enumerate), with the logic unchanged so verification keeps one definition
in meaning, and the torch selector MLP (selector).  This package imports
nothing of the JAX package; tests/test_torch_engine.py holds every registry
verifier here against its original, tests/test_torch_selector.py the
delayed-tree estimators and the selector."""
