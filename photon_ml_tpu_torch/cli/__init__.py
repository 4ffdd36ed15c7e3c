"""Command-line drivers of the port, run as
``python -m photon_ml_tpu_torch.cli.<driver>``."""
