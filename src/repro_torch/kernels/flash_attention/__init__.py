"""Flash attention forward kernel, its gradient and oracle (port of
``repro.kernels.flash_attention``)."""
