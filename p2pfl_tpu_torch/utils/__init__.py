"""Utility helpers (topologies, test helpers, singleton, the mTLS
certificates of the gRPC transport): the port's copy of
``p2pfl_tpu/utils/``."""
