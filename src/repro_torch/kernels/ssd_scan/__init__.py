"""Mamba-2 SSD chunked scan kernel, its gradient and oracle (port of
``repro.kernels.ssd_scan``)."""
