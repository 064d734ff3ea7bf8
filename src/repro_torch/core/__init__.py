"""Host core: copies of the numpy modules of src/repro/core that the engine
needs (trees, otlp, traversal, univer, greedy_bv, verify), with the logic
unchanged so verification keeps one definition in meaning.  This package
imports nothing of the JAX package; tests/test_torch_engine.py holds every
registry verifier here against its original."""
