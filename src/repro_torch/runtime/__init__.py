"""Step builders (port of src/repro/runtime)."""
