"""nerf_tpu_torch: the PyTorch and CUDA port of nerf_tpu for NVIDIA Hopper.

The JAX package ``nerf_tpu`` stays the reference; this package imports
neither it nor JAX.  Plain tensor code is PyTorch, and every Pallas kernel
of the ported paths is a CUDA kernel written by hand for ``sm_90a``
(``ops/csrc``).  Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise rather than run on the CPU.

Ported so far: the vanilla render path (``python -m nerf_tpu_torch -r``) and
the vanilla training step and trainer (``python -m nerf_tpu_torch``).
"""
