"""The port's hand-written CUDA kernels, one module each, every one beside
its plain PyTorch version and counting its launches.

=======  ==========================================  =====================
kernel   replaces (JAX package)                      module / source
=======  ==========================================  =====================
K1 fps   ops/pallas/fps.py::fps_pallas               fps.py / csrc/fps.cu
K2 query ops/pallas/query.py::ball_query_pallas      query.py / query.cu
K3 interp ops/pallas/interp.py::three_interpolate_fused  interp.py / interp.cu
K3 interp_bwd ops/pallas/interp.py::_fused_bwd       interp.py / interp_bwd.cu
K4 winner ops/pallas/winner.py::winner_stats_fused   winner.py / winner.cu
=======  ==========================================  =====================
"""
from pvn3d_tpu_torch.ops.kernels import fps, interp, query, winner

KERNELS = (fps.KERNEL, query.KERNEL, interp.KERNEL, interp.KERNEL_BWD,
           winner.KERNEL)
