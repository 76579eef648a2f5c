"""Multi-device sharding over torch.distributed, one process per device
(port of lcpc_tpu/parallel): `multihost` (the process group and meshes),
`comm` (the collectives), `mesh_protocol` (the sharded commit, by rows or
wide rows, and prove), `dist_ntt` (the 4-step NTT across ranks) and
`mesh_streaming` (the row-blocked sharded commit)."""
