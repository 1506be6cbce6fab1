"""Data for the port (port of vicasplat_tpu/data/): the synthetic scene
generator and dataset, the view samplers, and the per-stage loaders."""
