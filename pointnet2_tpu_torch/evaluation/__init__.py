"""Evaluation protocols of the port: vote ensembling, part mIoU, ScanNet
chopped and whole-scene evaluation."""

from pointnet2_tpu_torch.evaluation.cls_vote import evaluate_cls_voting
from pointnet2_tpu_torch.evaluation.part_miou import (
    PartSegMetrics,
    constrained_part_prediction,
    evaluate_part_seg_voting,
)
from pointnet2_tpu_torch.evaluation.scannet_eval import (
    ScanNetMetrics,
    evaluate_scannet_chopped,
    evaluate_scannet_whole_scene,
    make_scannet_eval_protocol,
)

__all__ = ["PartSegMetrics", "ScanNetMetrics", "constrained_part_prediction",
           "evaluate_cls_voting", "evaluate_part_seg_voting",
           "evaluate_scannet_chopped", "evaluate_scannet_whole_scene",
           "make_scannet_eval_protocol"]
