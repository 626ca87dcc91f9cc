"""Distribution primitives (port of src/repro/distributed): the
single-rank capacity-bucketed dispatch that the MoE layer runs without a
mesh.  The ``torch.distributed`` half comes with the distributed slice
(ROADMAP §1 item 7)."""
