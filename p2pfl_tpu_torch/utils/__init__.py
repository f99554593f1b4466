"""Utility helpers (topologies, test helpers, singleton): the port's copy of
``p2pfl_tpu/utils/``, without the TLS certificate helpers (they come with the
gRPC transport)."""
