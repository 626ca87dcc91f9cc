"""Optimizers (port of src/repro/optim)."""
