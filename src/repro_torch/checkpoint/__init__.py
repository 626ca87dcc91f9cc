"""Checkpointing (port of src/repro/checkpoint)."""
