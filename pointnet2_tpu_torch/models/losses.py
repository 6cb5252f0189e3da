"""Loss functions of the ported models.

Port of pointnet2_tpu/models/losses.py:17-69, all computed in float32:

- classification and part segmentation: the mean sparse softmax
  cross-entropy of the reference's get_loss (models/pointnet2_cls_ssg.py:
  47-54, models/pointnet2_part_seg.py:44-51);
- semantic segmentation: the per-point weighted cross-entropy, summed and
  divided by the count of nonzero weights (tf.losses'
  SUM_BY_NONZERO_WEIGHTS, models/pointnet2_sem_seg.py:48-55).
"""

from __future__ import annotations

import torch


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Per-example softmax cross-entropy over the last axis, in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0]


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        sample_weight: torch.Tensor | None = None,
                        sum_count: bool = False):
    """logits (B, C), labels (B,) int -> scalar mean CE.

    ``sample_weight`` (B,) masks padded rows out of the reduction.
    ``sum_count=True`` returns the unreduced (weighted_sum, weight_count)
    pair so a caller can normalise by another count."""
    ce = _cross_entropy(logits, labels)
    if sample_weight is None:
        sample_weight = torch.ones_like(ce)
    num = torch.sum(ce * sample_weight)
    den = sample_weight.sum()
    if sum_count:
        return num, den
    return num / torch.clamp_min(den, 1.0)


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor,
                      sample_weight: torch.Tensor | None = None,
                      sum_count: bool = False):
    """logits (B, N, C), labels (B, N) int -> scalar mean per-point CE.
    ``sample_weight`` (B,) masks padded examples (see
    classification_loss)."""
    ce = _cross_entropy(logits, labels)
    n = ce.shape[1]
    if sample_weight is None:
        sample_weight = torch.ones(ce.shape[0], dtype=ce.dtype,
                                   device=ce.device)
    num = torch.sum(ce * sample_weight[:, None])
    den = sample_weight.sum() * n
    if sum_count:
        return num, den
    return num / torch.clamp_min(den, 1.0)


def weighted_segmentation_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smpw: torch.Tensor,
                               sample_weight: torch.Tensor | None = None,
                               sum_count: bool = False):
    """Per-point weighted CE, logits (B, N, C), labels and ``smpw`` (B, N),
    normalised by the number of nonzero weights."""
    if sample_weight is not None:
        smpw = smpw * sample_weight[:, None]
    ce = _cross_entropy(logits, labels)
    num = torch.sum(ce * smpw)
    den = torch.sum(smpw != 0).float()
    if sum_count:
        return num, den
    return num / torch.clamp_min(den, 1.0)
