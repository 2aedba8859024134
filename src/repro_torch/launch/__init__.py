"""Launchers of the port: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``; ``steps`` holds the step functions,
``mesh`` the meshes and ``spawn`` the local multi-rank runner."""
