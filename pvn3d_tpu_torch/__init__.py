"""PyTorch/CUDA port of ``pvn3d_tpu`` for one NVIDIA H100.

The serving path of the JAX package (PVN3D forward, seg argmax, votes to
poses) in PyTorch, with the four Pallas TPU kernels rewritten as CUDA
kernels for ``sm_90a`` (``ops/kernels``, ``csrc``).  Imports nothing of JAX
and nothing of ``pvn3d_tpu``.  Entry point:
``inference.pipeline.make_inference_step``.
"""
