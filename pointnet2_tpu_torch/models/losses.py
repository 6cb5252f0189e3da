"""Loss functions of the ported models.

Port of pointnet2_tpu/models/losses.py:17-36: the mean sparse softmax
cross-entropy of the reference's get_loss (models/pointnet2_cls_ssg.py:
47-54), computed in float32.
"""

from __future__ import annotations

import torch


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        sample_weight: torch.Tensor | None = None,
                        sum_count: bool = False):
    """logits (B, C), labels (B,) int -> scalar mean CE.

    ``sample_weight`` (B,) masks padded rows out of the reduction.
    ``sum_count=True`` returns the unreduced (weighted_sum, weight_count)
    pair so a caller can normalise by another count."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if sample_weight is None:
        sample_weight = torch.ones_like(ce)
    num = torch.sum(ce * sample_weight)
    den = sample_weight.sum()
    if sum_count:
        return num, den
    return num / torch.clamp_min(den, 1.0)
