"""Image layout and colour tables (port of vicasplat_tpu/visualization)."""
