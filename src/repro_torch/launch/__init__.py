"""Launchers of the port: the trainer, ``python -m
repro_torch.launch.train`` (the reference's ``launch`` package, one
device)."""
