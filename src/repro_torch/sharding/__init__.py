"""Logical-axis sharding rules over ``launch.mesh`` meshes (port of
src/repro/sharding)."""
