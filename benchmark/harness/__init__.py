"""The benchmark harness: general code that every cell runs."""
