"""Configurations the port can serve (``llama3_2_3b``, ``kimi_k2_1t_a32b``:
each with ``CONFIG`` and ``SMOKE``)."""
