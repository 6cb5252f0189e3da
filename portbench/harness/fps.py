"""The share of its bound that farthest point sampling reaches at a model's
shapes: the public op ``farthest_point_sample`` alone, timed between CUDA
events, at each sampling of one forward of the cell's batch."""

from __future__ import annotations

LAUNCHES = 20


def roofline_pct(run) -> float | None:
    """100 x (the least time of the samplings' operations) / (their
    measured time); None without a card or an input."""
    torch = run.torch
    if run.fps_input is None or run.device.type != "cuda":
        return None
    from pointnet2_tpu_torch.ops import farthest_point_sample

    xyz = run.fps_input[..., :3].contiguous().float()
    B = xyz.shape[0]
    bound = measured = 0.0
    for n, npoint in run.ref.fps_shapes(run.cfg):
        if xyz.shape[1] != n:
            raise ValueError(f"fps input of {xyz.shape[1]} points, the "
                             f"configuration samples {n}")
        idx = farthest_point_sample(xyz, npoint)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LAUNCHES):
            farthest_point_sample(xyz, npoint)
        end.record()
        end.synchronize()
        measured += start.elapsed_time(end) * 1e-3 / LAUNCHES
        bound += run.counts.fps_bound_s(n, npoint, B)
        rows = torch.arange(B, device=xyz.device)[:, None]
        xyz = xyz[rows, idx.long()].contiguous()
    return 100.0 * bound / measured
