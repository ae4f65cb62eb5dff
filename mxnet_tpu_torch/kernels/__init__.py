"""Hand-written CUDA kernels for Hopper (``csrc/``) with their wrappers
and plain PyTorch versions: ``flash_attention`` (the forward) and
``paged_attention``.  Built at first use by ``_build.py``."""
