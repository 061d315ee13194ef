"""rvgrt_tpu_torch: the voxel ray tracer of ``rvgrt_tpu`` in PyTorch + CUDA.

The same tree and public names as the JAX package (``rvgrt_tpu``), which
stays the reference.  Plain tensor code is PyTorch; the three kernels the
JAX package wrote in Pallas are hand-written CUDA kernels for Hopper
(``csrc/``, bound in ``ops/``), each beside its plain PyTorch version.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of running on the CPU.
"""
