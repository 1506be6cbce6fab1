"""Scripts that measure or diagnose the port on a CUDA card; each runs as
`python -m vicasplat_tpu_torch.diagnostics.<name>` from the repository
root and writes its record as JSON."""
