"""Runnable examples of the port (counterparts of ``p2pfl_tpu/examples/``)."""
