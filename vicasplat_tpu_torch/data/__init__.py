"""Data for the port (port of vicasplat_tpu/data/): the synthetic scene
generator, in numpy."""
