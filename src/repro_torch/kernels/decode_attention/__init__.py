"""Single-token decode attention kernel and oracle (port of
``repro.kernels.decode_attention``)."""
