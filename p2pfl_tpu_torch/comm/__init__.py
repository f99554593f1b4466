"""The port's communication plane: so far the sparse-delta wire codec
(``delta.py``); the transport, gossip and commands come with ``Node``."""
