"""Launch-time tooling of the port (the port of ``repro.launch``): the
production meshes (:mod:`~repro_torch.launch.mesh`), the sharding rules
over DTensor (:mod:`~repro_torch.launch.sharding`), elastic re-planning
of sharded plans and resharding of checkpoints
(:mod:`~repro_torch.launch.elastic`), the op-level cost counter
(:mod:`~repro_torch.launch.op_analysis`,
:mod:`~repro_torch.launch.collectives`), the dry run on fake tensors
(:mod:`~repro_torch.launch.dryrun`) and the LM train CLI
(:mod:`~repro_torch.launch.train`).  Importing it touches no process
group."""
