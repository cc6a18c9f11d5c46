"""Launchers of the port: the trainer, ``python -m
repro_torch.launch.train`` (the reference's ``launch`` package, one
device); the cells under a policy (``launch.steps``); and the dry run,
``python -m repro_torch.launch.dryrun``."""
