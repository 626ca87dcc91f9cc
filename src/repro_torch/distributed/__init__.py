"""Distribution primitives (port of src/repro/distributed): the
capacity-bucketed dispatch that the MoE layer runs without a mesh and the
sharded geo lookup routes points with (``core.strategies``).  The geo
lookup's mesh is ``launch.mesh.Mesh`` over ``torch.distributed``; the
model half (parameter sharding, the MoE layer's mesh) comes with ROADMAP
§1 item 7."""
