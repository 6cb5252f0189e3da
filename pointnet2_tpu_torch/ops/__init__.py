"""Point ops of the port: FPS, ball query (single, with grouped xyz, and
multi-radius), kNN, row gathers with their scatter-add gradient, max
pooling, the three-NN search and interpolation of feature propagation, and
the fused SA chain's forward and backward (``ops.fused_mlp``), and
probability sampling with the area-weighted mesh sampler (``ops.mesh``).

``KERNELS`` names each hand-written CUDA kernel's wrapper; a wrapper's
``launches`` attribute counts its launches.
"""

from pointnet2_tpu_torch.ops.fused_mlp import (
    fused_affine_kernel,
    fused_dense_bwd_kernel,
    fused_dense_kernel,
    fused_first_bwd_kernel,
    fused_pool_kernel,
    fused_top_stats_kernel,
)
from pointnet2_tpu_torch.ops.grouping import (
    ball_query_group_xyz_kernel,
    ball_query_kernel,
    ball_query_multi_kernel,
    gather_rows_kernel,
    group_point,
    knn_point,
    query_ball_and_group_xyz,
    query_ball_point,
    query_ball_point_multi,
    scatter_rows,
    scatter_rows_kernel,
)
from pointnet2_tpu_torch.ops.interpolate import (
    three_interpolate,
    three_nn,
    three_nn_kernel,
)
from pointnet2_tpu_torch.ops.mesh import sample_mesh, triangle_areas
from pointnet2_tpu_torch.ops.pooling import max_pool
from pointnet2_tpu_torch.ops.sampling import (
    farthest_point_sample,
    fps_kernel,
    gather_point,
    prob_sample,
)

KERNELS = {
    "fps": fps_kernel,
    "ball_query": ball_query_kernel,
    "ball_query_group_xyz": ball_query_group_xyz_kernel,
    "ball_query_multi": ball_query_multi_kernel,
    "gather_rows": gather_rows_kernel,
    "scatter_rows": scatter_rows_kernel,
    "three_nn": three_nn_kernel,
    "fused_dense": fused_dense_kernel,
    "fused_pool": fused_pool_kernel,
    "fused_affine": fused_affine_kernel,
    "fused_top_stats": fused_top_stats_kernel,
    "fused_dense_bwd": fused_dense_bwd_kernel,
    "fused_first_bwd": fused_first_bwd_kernel,
}

__all__ = [
    "KERNELS",
    "farthest_point_sample",
    "gather_point",
    "group_point",
    "knn_point",
    "max_pool",
    "prob_sample",
    "query_ball_and_group_xyz",
    "query_ball_point",
    "query_ball_point_multi",
    "sample_mesh",
    "scatter_rows",
    "three_interpolate",
    "three_nn",
    "triangle_areas",
]
