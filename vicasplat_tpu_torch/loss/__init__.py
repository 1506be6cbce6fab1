"""Training losses (port of vicasplat_tpu/loss)."""
