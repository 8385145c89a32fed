"""kubernetes_tpu_torch -- the batched pod scheduler on PyTorch and CUDA.

The port of ``kubernetes_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It mirrors the JAX package's sub-packages and module names, so each
counterpart sits at the same relative path. It imports neither ``jax`` nor
anything of ``kubernetes_tpu``: the host layers it needs (``api``,
``tensorize`` and the ``ops/oracle`` helpers the tensorizers call) are
copies.

Package map:
- ``api``        -- core/v1 object subset, Quantity, label selectors (copied)
- ``tensorize``  -- API objects -> padded numpy tables (copied)
- ``ops``        -- plugin kernels as torch functions, and the hand-written
  CUDA kernel ``domain_counts`` (``csrc/domain_counts.cu``)
- ``solver``     -- the exact-parity solve: the per-pod scan, the grouped
  path, nominated pods, the device session, the memory budget model
- ``convert``    -- the JAX package's tensorized objects -> the port's
- ``device``     -- device resolution: CUDA unless the caller asks for the CPU
- ``build``      -- nvcc build of ``csrc/`` at first use, loaded with ctypes
"""
