"""Launch-time tooling of the port: elastic re-planning of sharded plans
(:mod:`repro_torch.launch.elastic`) and the LM training driver
(:mod:`repro_torch.launch.train`)."""
