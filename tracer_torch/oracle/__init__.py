"""CPU oracle tracer (golden reference for tests and the smoke run)."""
