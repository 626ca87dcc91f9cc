"""Distribution primitives (port of src/repro/distributed): the
capacity-bucketed dispatch that the MoE layer runs on each rank's experts
and the sharded geo lookup routes points with (``core.strategies``).
The mesh is ``launch.mesh.Mesh`` over ``torch.distributed``; parameter
placement is ``sharding.rules``, the MoE layer's mesh path
``models.moe``."""
