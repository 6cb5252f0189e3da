"""ShapeNet-part mIoU protocol.

Port of pointnet2_tpu/evaluation/part_miou.py, parity with the reference's
part_seg/train_one_hot.py:282-324 and part_seg/evaluate.py:150-191:

- predictions are constrained to the ground-truth category's part labels
  (argmax over ``SEG_CLASSES[cat]`` only);
- per-part IoU with the absent-part rule: a part with no ground-truth and
  no predicted point scores 1.0;
- a shape's IoU is the mean over its category's parts, reported averaged
  by category ("eval mean mIoU") and over all shapes ("eval mean mIoU
  (all shapes)", the paper's headline number).
"""

from __future__ import annotations

import numpy as np

from pointnet2_tpu_torch.data.shapenet_part import (
    NUM_PARTS,
    SEG_CLASSES,
    SEG_LABEL_TO_CAT,
)
from pointnet2_tpu_torch.evaluation.lockstep import lockstep_batches
from pointnet2_tpu_torch.parallel import multihost


def constrained_part_prediction(logits: np.ndarray,
                                seg_labels: np.ndarray) -> np.ndarray:
    """Category-constrained argmax. logits (B, N, NUM_PARTS); seg_labels
    (B, N), whose first point's label names each shape's category."""
    B, N = seg_labels.shape
    pred = np.zeros((B, N), np.int32)
    for i in range(B):
        parts = SEG_CLASSES[SEG_LABEL_TO_CAT[int(seg_labels[i, 0])]]
        pred[i] = np.argmax(logits[i][:, parts], axis=1) + parts[0]
    return pred


class PartSegMetrics:
    """Accumulates the reference's part-seg metrics across batches."""

    def __init__(self):
        self.shape_ious: dict[str, list[float]] = {c: [] for c in SEG_CLASSES}
        self.total_correct = 0
        self.total_seen = 0
        self.seen_class = np.zeros(NUM_PARTS, np.int64)
        self.correct_class = np.zeros(NUM_PARTS, np.int64)

    def update(self, logits: np.ndarray, seg_labels: np.ndarray) -> None:
        """logits (B, N, NUM_PARTS) float; seg_labels (B, N) int."""
        pred = constrained_part_prediction(logits, seg_labels)
        self.total_correct += int((pred == seg_labels).sum())
        self.total_seen += seg_labels.size
        for l in range(NUM_PARTS):
            self.seen_class[l] += int((seg_labels == l).sum())
            self.correct_class[l] += int(((pred == l)
                                          & (seg_labels == l)).sum())
        for i in range(seg_labels.shape[0]):
            segp, segl = pred[i], seg_labels[i]
            cat = SEG_LABEL_TO_CAT[int(segl[0])]
            part_ious = []
            for l in SEG_CLASSES[cat]:
                gt, pr = segl == l, segp == l
                if not gt.any() and not pr.any():
                    part_ious.append(1.0)  # absent part, no prediction
                else:
                    part_ious.append((gt & pr).sum() / float((gt | pr).sum()))
            self.shape_ious[cat].append(float(np.mean(part_ious)))

    def allreduced(self) -> "PartSegMetrics":
        """The metrics summed over the processes (this object with one),
        as pointnet2_tpu/evaluation/part_miou.py:81-99: the per-shape IoUs
        reduce as (sum, count) per category, which keeps both the category
        means and each shape's weight in the all-shapes mean."""
        if multihost.process_count() == 1:
            return self
        cats = sorted(SEG_CLASSES)
        per_cat = multihost.allreduce_sum(np.array(
            [[float(np.sum(self.shape_ious[c])), len(self.shape_ious[c])]
             for c in cats], np.float64))
        out = PartSegMetrics()
        for (total, n), c in zip(per_cat, cats):
            out.shape_ious[c] = [total / n] * int(n) if n else []
        scalars = multihost.allreduce_sum(np.array(
            [self.total_correct, self.total_seen], np.int64))
        out.total_correct, out.total_seen = int(scalars[0]), int(scalars[1])
        out.seen_class = multihost.allreduce_sum(self.seen_class)
        out.correct_class = multihost.allreduce_sum(self.correct_class)
        return out

    def result(self, log_fn=print) -> dict:
        cat_miou = {c: float(np.mean(v)) for c, v in self.shape_ious.items()
                    if v}
        all_ious = [iou for v in self.shape_ious.values() for iou in v]
        acc = self.total_correct / max(self.total_seen, 1)
        present = self.seen_class > 0
        avg_class_acc = float(
            (self.correct_class[present]
             / np.maximum(self.seen_class[present], 1)).mean()) \
            if present.any() else 0.0
        mean_cat_miou = (float(np.mean(list(cat_miou.values())))
                         if cat_miou else 0.0)
        instance_miou = float(np.mean(all_ious)) if all_ious else 0.0
        log_fn(f"eval accuracy: {acc:.6f}")
        log_fn(f"eval avg class acc: {avg_class_acc:.6f}")
        for cat in sorted(cat_miou):
            log_fn(f"eval mIoU of {cat}:\t {cat_miou[cat]:.6f}")
        log_fn(f"eval mean mIoU: {mean_cat_miou:.6f}")
        log_fn(f"eval mean mIoU (all shapes): {instance_miou:.6f}")
        return {
            "accuracy": acc,
            "avg_class_accuracy": avg_class_acc,
            "category_miou": cat_miou,
            "mean_category_miou": mean_cat_miou,
            "instance_miou": instance_miou,
        }


def evaluate_part_seg_voting(eval_logits_fn, dataset, num_votes: int = 12,
                             rng=None, log_fn=print) -> dict:
    """Vote-ensembled part segmentation (part_seg/evaluate.py:29,138-144):
    each vote shuffles the point order, and its per-point logits are
    scattered back to the original order before the sum, so votes stay
    point-aligned. eval_logits_fn(batch dict) -> (B, N, NUM_PARTS) logits;
    the votes are stacked along the batch (``cls_label``, ``seg`` tiled)
    and scored in one call a batch."""
    rng = rng if isinstance(rng, np.random.Generator) else \
        np.random.default_rng(rng)
    metrics = PartSegMetrics()
    for batch in lockstep_batches(dataset, multihost):
        pts, seg, nvalid = batch["points"], batch["seg"], batch["nvalid"]
        B, N = pts.shape[:2]
        perms = [rng.permutation(N) for _ in range(num_votes)]
        vote_batch = {k: np.concatenate([np.asarray(v)] * num_votes, axis=0)
                      for k, v in batch.items() if k != "nvalid"}
        vote_batch["points"] = np.concatenate([pts[:, p] for p in perms],
                                              axis=0)
        logits = np.asarray(eval_logits_fn(vote_batch), np.float64)
        logits = logits.reshape(num_votes, B, N, -1)
        pred_sum = np.zeros((B, N, NUM_PARTS), np.float64)
        for v, perm in enumerate(perms):
            pred_sum[:, perm, :] += logits[v]
        metrics.update(pred_sum[:nvalid], seg[:nvalid])
    return metrics.allreduced().result(log_fn)
