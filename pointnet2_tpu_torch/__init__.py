"""PyTorch/CUDA port of pointnet2_tpu for NVIDIA Hopper (H100).

The JAX package ``pointnet2_tpu`` is the reference; this package imports
nothing of it, nor JAX. The point ops with a Pallas kernel on the TPU run a
hand-written CUDA kernel here (``csrc/``, built with nvcc at first use) on
CUDA tensors, and a plain PyTorch version on CPU tensors. Nothing is built
or launched at import.

Ported so far: ``pointnet2_cls_ssg`` with its bucketed serving
``Predictor`` and its training (``train.Trainer``: on-device augmentation,
train-mode BN and dropout, the scatter-add gradient of the row gather,
Adam or momentum on the scheduled LR); the segmentation models
``pointnet2_sem_seg`` and ``pointnet2_part_seg`` with their serving
(per-point logits from ``Predictor``, whole scenes from
``Predictor.predict_scene``); the multi-scale-grouping models
``pointnet2_cls_msg`` and ``pointnet2_part_seg_msg_one_hot`` (served with
a category label, ``Predictor(points, cls_label)``), the PointNet baseline
``pointnet_cls_basic``, and every option of the set-abstraction layers;
training of every model, with checkpoints and exact resume
(``train.checkpoint``), the evaluation protocols (``evaluation``: the
vote, part mIoU, ScanNet's chopped and whole-scene passes),
``Predictor.from_checkpoint``, the command-line tools (``cli.train``,
``cli.evaluate``, ``cli.supervise``, ``cli.visualize``,
``cli.plot_metrics``), scale-out over ranks, the data tools
(``data.ingest``, ``data.scannet_preprocessing``, the procedural
stand-ins), the viewer (``viz``), mesh sampling (``ops.sample_mesh``), the
conv/pool layers (``nn.extras``), the profiling helpers and the demos
(``examples``): everything of the JAX package but its benchmark harness.
"""

from pointnet2_tpu_torch.convert import flax_to_torch
from pointnet2_tpu_torch.models import (
    MODEL_REGISTRY,
    PointNet2ClsMSG,
    PointNet2ClsSSG,
    PointNet2PartSeg,
    PointNet2PartSegMSGOneHot,
    PointNet2SemSeg,
    PointNetClsBasic,
    get_model,
)
from pointnet2_tpu_torch.serving import Predictor
from pointnet2_tpu_torch.train import TrainConfig, Trainer

__all__ = [
    "MODEL_REGISTRY",
    "PointNet2ClsMSG",
    "PointNet2ClsSSG",
    "PointNet2PartSeg",
    "PointNet2PartSegMSGOneHot",
    "PointNet2SemSeg",
    "PointNetClsBasic",
    "Predictor",
    "TrainConfig",
    "Trainer",
    "flax_to_torch",
    "get_model",
]
