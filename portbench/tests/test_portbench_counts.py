"""The work the utilisation metrics divide by, reckoned from widths and
shapes by each configuration's reference (``forward_flops``,
``fps_shapes``): the dense FLOPs equal ``FlopCounterMode``'s count of the
port's unfused plain route (the published grouping, ``fuse_first`` off),
and do not move with the fused chain's gate; the FPS operation count is
PERF.md's row 1 bound."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pointnet2_tpu_torch import config as pconfig
from pointnet2_tpu_torch.models import get_spec
from pointnet2_tpu_torch.nn.pointnet import SetAbstraction

from portbench.harness import counts, spec, weights


def _counted(cfg: dict, B: int) -> float:
    model = get_spec(cfg["model"]).cls(num_classes=cfg["num_classes"],
                                       device="cpu")
    model.load_state_dict(weights.make(torch, cfg, 3, "cpu"))
    for m in model.modules():
        if isinstance(m, SetAbstraction):
            m.fuse_first = False
    x = torch.rand(B, cfg["num_point"], cfg["in_channels"]) * 2 - 1
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(x)
    return fc.get_total_flops()


@pytest.mark.parametrize("name,B,N", [
    ("pointnet2_cls_ssg-modelnet40", 2, 1024),
    ("pointnet2_sem_seg-scannet", 1, 2048)])
def test_dense_flops_equal_flop_counter(name, B, N):
    bench = spec.load_benchmark()
    cfg = spec.config(bench, name)
    cfg["num_point"] = N
    ref = spec.reference(name)
    assert ref.forward_flops(cfg) * B == _counted(cfg, B)


@pytest.mark.parametrize("name", ["pointnet2_cls_ssg-modelnet40",
                                  "pointnet2_sem_seg-scannet"])
def test_dense_flops_ignore_the_fused_gate(name):
    cfg = spec.config(spec.load_benchmark(), name)
    ref = spec.reference(name)
    with pconfig.fused_mlp(True):
        on = ref.forward_flops(cfg)
    gated = copy.deepcopy(cfg)
    gated["fused_mlp"] = True
    assert on == ref.forward_flops(cfg) == ref.forward_flops(gated)


def test_published_sizes():
    bench = spec.load_benchmark()
    cls = spec.config(bench, "pointnet2_cls_ssg-modelnet40")
    sem = spec.config(bench, "pointnet2_sem_seg-scannet")
    cls_ref = spec.reference("pointnet2_cls_ssg-modelnet40")
    sem_ref = spec.reference("pointnet2_sem_seg-scannet")
    # 2 x (3*64 + 64*64 + 64*128) x 512*32 + ... (PERF.md: ~1.67 GFLOP)
    assert cls_ref.forward_flops(cls) == 1675055104
    assert counts.TRAIN_STEP_FORWARDS == 3
    assert cls_ref.fps_shapes(cls) == [(1024, 512), (512, 128)]
    assert sem_ref.fps_shapes(sem) == [(8192, 1024), (1024, 256), (256, 64),
                                      (64, 16)]


def test_fps_operations_match_perf_row_1():
    # PERF.md section 6 row 1: npoint x N x 10 f32 operations a cloud at
    # 33.5e12/s; cls_ssg's two samplings of 16 clouds 0.00281 ms, sem_seg
    # SA1 (16, 8192 -> 1024) 0.0400 ms
    cls_ms = 1e3 * (counts.fps_bound_s(1024, 512, 16)
                    + counts.fps_bound_s(512, 128, 16))
    assert cls_ms == pytest.approx(0.00281, abs=1e-5)
    assert 1e3 * counts.fps_bound_s(8192, 1024, 16) == pytest.approx(
        0.0400, abs=1e-4)
    assert counts.fps_ops(8192, 1024, 1) == 1024 * 8192 * 10
