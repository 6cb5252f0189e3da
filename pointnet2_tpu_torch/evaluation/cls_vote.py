"""Multi-angle vote ensembling of classification logits (host-stacked).

Port of pointnet2_tpu/evaluation/cls_vote.py, protocol parity with the
reference's evaluate.py:100-158: per vote, shuffle the point order
(diversifies the farthest-point-sampling seeds) and rotate about the up
axis by vote_idx/num_votes * 2*pi (normal-aware when the cloud has 6
channels), then sum the logits over votes and take the argmax.
``evaluate_cls_voting`` reports overall accuracy, average class accuracy
and the per-class table.
"""

from __future__ import annotations

import numpy as np

from pointnet2_tpu_torch.data import augment as A
from pointnet2_tpu_torch.evaluation.lockstep import lockstep_batches
from pointnet2_tpu_torch.parallel import multihost


def vote_views(pts: np.ndarray, num_votes: int, rng) -> np.ndarray:
    """The protocol's num_votes views of a batch, stacked along batch: view
    v is the batch point-order-shuffled (one shared permutation per vote)
    and rotated about the up axis by v/num_votes * 2*pi. Returns
    (num_votes * B, N, C); rows [v*B:(v+1)*B] are vote v."""
    num_point = pts.shape[1]
    views = []
    for vote_idx in range(num_votes):
        shuffled = rng.permutation(num_point)
        views.append(A.rotate_point_cloud_by_angle(
            pts[:, shuffled, :], vote_idx / float(num_votes) * np.pi * 2))
    return np.concatenate(views, axis=0)


def vote_logits(eval_logits_fn, pts: np.ndarray, num_votes: int,
                rng=None) -> np.ndarray:
    """Summed logits (float64) over the voting protocol. All votes are
    stacked along the batch axis and scored in one eval_logits_fn call."""
    rng = rng if isinstance(rng, np.random.Generator) else \
        np.random.default_rng(rng)
    B = pts.shape[0]
    stacked = vote_views(pts, num_votes, rng)
    logits = np.asarray(eval_logits_fn(stacked), np.float64)
    return logits.reshape(num_votes, B, -1).sum(axis=0)


def evaluate_cls_voting(eval_logits_fn, dataset, num_votes: int = 12,
                        num_classes: int = 40, rng=None,
                        log_fn=print) -> dict:
    """eval_logits_fn(points (B, N, C) f32) -> logits (B, num_classes).

    One generator serves the whole protocol (an int seeds it once), so the
    permutations carry on across batches. Only the first ``nvalid`` rows
    of a batch count. Returns {"accuracy", "avg_class_accuracy",
    "class_accuracy", "per_class_seen"}."""
    rng = rng if isinstance(rng, np.random.Generator) else \
        np.random.default_rng(rng)
    total_correct = 0
    total_seen = 0
    seen_class = np.zeros(num_classes, np.int64)
    correct_class = np.zeros(num_classes, np.int64)
    for batch in lockstep_batches(dataset, multihost):
        nvalid = batch["nvalid"]
        pred_sum = vote_logits(eval_logits_fn, batch["points"], num_votes,
                               rng)
        pred = pred_sum.argmax(axis=1)[:nvalid]
        label = batch["label"][:nvalid]
        total_correct += int((pred == label).sum())
        total_seen += nvalid
        for lbl, prd in zip(label, pred):
            seen_class[lbl] += 1
            correct_class[lbl] += int(prd == lbl)

    counters = multihost.allreduce_sum(np.array(
        [total_correct, total_seen], np.int64))
    total_correct, total_seen = int(counters[0]), int(counters[1])
    seen_class = multihost.allreduce_sum(seen_class)
    correct_class = multihost.allreduce_sum(correct_class)

    acc = total_correct / max(total_seen, 1)
    class_acc = correct_class / np.maximum(seen_class, 1)
    present = seen_class > 0
    avg_class_acc = float(class_acc[present].mean()) if present.any() else 0.0
    log_fn(f"eval accuracy: {acc:.6f}")
    log_fn(f"eval avg class acc: {avg_class_acc:.6f}")
    return {
        "accuracy": acc,
        "avg_class_accuracy": avg_class_acc,
        "class_accuracy": class_acc,
        "per_class_seen": seen_class,
    }
