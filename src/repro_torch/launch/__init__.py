"""Launchers (port of src/repro/launch)."""
