"""Hand-written CUDA kernels for Hopper (``csrc/``) with their wrappers
and plain PyTorch versions: ``flash_attention`` (forward and backward),
``paged_attention``, ``fused_optimizer`` (grouped SGD) and
``fused_conv`` (the 3x3 convolution).  Built at first use by
``_build.py``; ``_cuda_rt.py`` compiles user CUDA source at run time
(NVRTC) for ``mx.rtc``."""
