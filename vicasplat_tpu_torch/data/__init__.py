"""Data for the port (port of vicasplat_tpu/data/): the synthetic scene
generator and dataset, the RE10K-format chunk reader and the ScanNet
reader, the view samplers, the crop and augmentation shims, COLMAP and
scene conversion, and the per-stage loaders."""
