"""The model stack (port of src/repro/models): the dense decoder family
for serving, with self-attention on the hand-written flash kernel."""
