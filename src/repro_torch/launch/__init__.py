"""Launchers of the PyTorch port (``python -m repro_torch.launch.serve``)."""
