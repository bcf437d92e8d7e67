"""The port's hand-written CUDA kernels, one module each, every one beside
its plain PyTorch version and counting its launches.

=================  ==========================================  ============
kernel             replaces (JAX package)                      module / source
=================  ==========================================  ============
K1 fps             ops/pallas/fps.py::fps_pallas               fps.py / fps.cu
K2 query           ops/grouping.py::ball_query_multi "exact"   query.py /
                                                               query.cu
K2 query_expanded  ops/grouping.py::ball_query_multi "approx"  (one source,
K2 query_bf16      ball_query_multi compute_dtype="bf16"        four
K2 query_capacity  ops/pallas/query.py::ball_query_pallas       instances)
K3 interp          ops/pallas/interp.py::three_interpolate_fused  interp.py /
K3 interp_expanded ops/interpolate.py::three_nn (XLA arm)        interp.cu
K3 interp_bwd      ops/pallas/interp.py::_fused_bwd            interp.py /
                                                               interp_bwd.cu
K4 winner          ops/pallas/winner.py::winner_stats_fused    winner.py /
                                                               winner.cu
bn_stats           none: train-mode BatchNorm, plain jnp in    bn.py /
bn_finish          the JAX package (models/layers.py:29-69)    bn.cu
bn_apply                                                        (five
bn_bwd_reduce                                                   entry
bn_bwd_apply                                                    points)
knn                none: FFB6D's neighbour index (the JAX      knn.py /
                   package runs PVN3D only)                     knn.cu
meanshift          none: MeanShift's winner-mode shift loop,   meanshift.py
                   a ``lax.while_loop`` of ``jnp`` steps in     / meanshift.cu
                   the JAX package (inference/meanshift.py)
=================  ==========================================  ============

The instances of one source share its library and count their launches
apart.  ``KERNELS`` holds the ports of the TPU kernels, ``BN_KERNELS`` the
BatchNorm pair, which the training step alone launches, ``KNN_KERNELS``
the k-NN search, which FFB6D's serving step launches, and
``MEANSHIFT_KERNELS`` the shift loop, which every pose stage launches.
"""
from pvn3d_tpu_torch.ops.kernels import (bn, fps, interp, knn, meanshift,
                                         query, winner)

KERNELS = (fps.KERNEL, query.KERNEL, query.KERNEL_EXPANDED, query.KERNEL_BF16,
           query.KERNEL_CAPACITY, interp.KERNEL, interp.KERNEL_EXPANDED,
           interp.KERNEL_BWD, winner.KERNEL)
BN_KERNELS = bn.KERNELS
KNN_KERNELS = (knn.KERNEL,)
MEANSHIFT_KERNELS = (meanshift.KERNEL,)
