"""p2pfl_tpu_torch: the PyTorch/CUDA port of ``p2pfl_tpu`` for one NVIDIA H100.

The package mirrors ``p2pfl_tpu``'s module paths. It imports torch and numpy,
never JAX and nothing of ``p2pfl_tpu``. Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU; the CPU runs each
kernel's plain PyTorch version. See README.md, "PyTorch/CUDA port".
"""
