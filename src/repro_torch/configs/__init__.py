"""Configurations the port can serve (``llama3_2_3b``: ``CONFIG``, ``SMOKE``)."""
