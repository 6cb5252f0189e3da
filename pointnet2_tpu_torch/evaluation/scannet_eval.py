"""ScanNet semantic-segmentation evaluation protocols.

Port of pointnet2_tpu/evaluation/scannet_eval.py, parity with the
reference's scannet/train.py:

- random-crop evaluation (:252-323): a random z rotation a crop, point
  accuracy over annotated (label > 0) and weighted (smpw > 0) points,
  per-class accuracies, voxel accuracy by the first point's label of each
  2 cm surface voxel, and the average calibrated by the fixed
  ``CALIWEIGHTS``;
- whole-scene evaluation (:326-427): every 1.5 m block of every scene,
  batched (a block's prediction does not depend on its batch in eval
  mode), the same point and voxel metrics. Its calibrated voxel accuracy
  is the paper's headline number.
"""

from __future__ import annotations

import numpy as np

from pointnet2_tpu_torch.data import augment as A
from pointnet2_tpu_torch.data.scannet import NUM_CLASSES
from pointnet2_tpu_torch.evaluation.lockstep import lockstep_batches
from pointnet2_tpu_torch.parallel import multihost
from pointnet2_tpu_torch.utils.pc_util import (
    point_cloud_label_to_surface_voxel_label_fast,
)

# fixed calibration weights over the 20 annotated classes
# (scannet/train.py:316,418)
CALIWEIGHTS = np.array([0.388, 0.357, 0.038, 0.033, 0.017, 0.02, 0.016,
                        0.025, 0.002, 0.002, 0.002, 0.007, 0.006, 0.022,
                        0.004, 0.0004, 0.003, 0.002, 0.024, 0.029])


class ScanNetMetrics:
    """Accumulates point and surface-voxel accuracies."""

    def __init__(self):
        self.total_correct = 0
        self.total_seen = 0
        self.seen_class = np.zeros(NUM_CLASSES, np.int64)
        self.correct_class = np.zeros(NUM_CLASSES, np.int64)
        self.total_correct_vox = 0
        self.total_seen_vox = 0
        self.seen_class_vox = np.zeros(NUM_CLASSES, np.int64)
        self.correct_class_vox = np.zeros(NUM_CLASSES, np.int64)

    def update(self, points, pred, label, smpw) -> None:
        """points (B, N, 3); pred, label (B, N) int; smpw (B, N) float."""
        valid = (label > 0) & (smpw > 0)
        self.total_correct += int(((pred == label) & valid).sum())
        self.total_seen += int(valid.sum())
        for l in range(NUM_CLASSES):
            self.seen_class[l] += int(((label == l) & (smpw > 0)).sum())
            self.correct_class[l] += int(((pred == l) & (label == l)
                                          & (smpw > 0)).sum())
        for b in range(label.shape[0]):
            keep = smpw[b] > 0
            if not keep.any():
                continue
            stacked = np.stack([label[b, keep], pred[b, keep]], axis=1)
            _, uvlabel, _ = point_cloud_label_to_surface_voxel_label_fast(
                points[b, keep, :], stacked, res=0.02)
            self.total_correct_vox += int(((uvlabel[:, 0] == uvlabel[:, 1])
                                           & (uvlabel[:, 0] > 0)).sum())
            self.total_seen_vox += int((uvlabel[:, 0] > 0).sum())
            for l in range(NUM_CLASSES):
                self.seen_class_vox[l] += int((uvlabel[:, 0] == l).sum())
                self.correct_class_vox[l] += int(((uvlabel[:, 0] == l)
                                                  & (uvlabel[:, 1] == l)).sum())

    def counters(self) -> np.ndarray:
        """Every accumulator in one int64 vector (additive across data
        shards)."""
        return np.concatenate([
            np.array([self.total_correct, self.total_seen,
                      self.total_correct_vox, self.total_seen_vox],
                     np.int64),
            self.seen_class, self.correct_class,
            self.seen_class_vox, self.correct_class_vox,
        ])

    def load_counters(self, vec: np.ndarray) -> "ScanNetMetrics":
        (self.total_correct, self.total_seen, self.total_correct_vox,
         self.total_seen_vox) = (int(v) for v in vec[:4])
        n = NUM_CLASSES
        self.seen_class = vec[4:4 + n].copy()
        self.correct_class = vec[4 + n:4 + 2 * n].copy()
        self.seen_class_vox = vec[4 + 2 * n:4 + 3 * n].copy()
        self.correct_class_vox = vec[4 + 3 * n:4 + 4 * n].copy()
        return self

    def allreduced(self) -> "ScanNetMetrics":
        """The accumulators summed over the processes (a copy of these with
        one)."""
        return ScanNetMetrics().load_counters(
            multihost.allreduce_sum(self.counters()))

    def result(self, log_fn=print, prefix: str = "eval") -> dict:
        point_acc = self.total_correct / max(self.total_seen, 1)
        point_acc_vox = self.total_correct_vox / max(self.total_seen_vox, 1)
        cls_acc = self.correct_class[1:] / (self.seen_class[1:] + 1e-6)
        cls_acc_vox = self.correct_class_vox[1:] / (self.seen_class_vox[1:]
                                                    + 1e-6)
        avg_cls = float(cls_acc.mean())
        avg_cls_vox = float(cls_acc_vox.mean())
        caliacc = float(np.average(cls_acc_vox, weights=CALIWEIGHTS))
        caliacc_point = float(np.average(cls_acc, weights=CALIWEIGHTS))
        log_fn(f"{prefix} point accuracy vox: {point_acc_vox:.6f}")
        log_fn(f"{prefix} point avg class acc vox: {avg_cls_vox:.6f}")
        log_fn(f"{prefix} point accuracy: {point_acc:.6f}")
        log_fn(f"{prefix} point avg class acc: {avg_cls:.6f}")
        log_fn(f"{prefix} point calibrated average acc vox: {caliacc:.6f}")
        return {
            "point_accuracy": point_acc,
            "point_accuracy_vox": point_acc_vox,
            "avg_class_accuracy": avg_cls,
            "avg_class_accuracy_vox": avg_cls_vox,
            "calibrated_accuracy_vox": caliacc,
            "calibrated_accuracy_point": caliacc_point,
        }


def evaluate_scannet_chopped(eval_logits_fn, dataset, rng=None,
                             log_fn=print) -> dict:
    """Random-crop evaluation with a random z rotation a crop
    (scannet/train.py:252-323), the crops without the input dropout.
    eval_logits_fn(batch dict) -> (B, N, NUM_CLASSES) logits."""
    rng = rng if isinstance(rng, np.random.Generator) else \
        np.random.default_rng(rng)
    metrics = ScanNetMetrics()
    for batch in lockstep_batches(dataset, multihost, input_dropout=False):
        nvalid = batch["nvalid"]
        aug = A.rotate_point_cloud_z(batch["points"], rng)
        logits = np.asarray(eval_logits_fn(dict(batch, points=aug)))
        pred = logits.argmax(-1)
        metrics.update(aug[:nvalid], pred[:nvalid], batch["seg"][:nvalid],
                       batch["smpw"][:nvalid])
    return metrics.allreduced().result(log_fn, prefix="eval")


def evaluate_scannet_whole_scene(eval_logits_fn, whole_scene_dataset,
                                 batch_size: int = 16, log_fn=print) -> dict:
    """Whole-scene sliding-block evaluation (scannet/train.py:326-427).
    Blocks are batched `batch_size` at a time; the last batch is padded by
    repeating its last block, and only its real rows count. Returns the
    metrics, ``calibrated_accuracy_vox`` the headline number. On several
    processes each scores the blocks of its own scenes and the counters are
    summed: the port's eval forward holds no collective, so a process with
    fewer blocks feeds no dummy batches (JAX scannet_eval.py:185-195 must,
    its forward being one program over every process)."""
    metrics = ScanNetMetrics()
    block_pts, block_seg, block_w = [], [], []

    def flush(force=False):
        while len(block_pts) >= batch_size or (force and block_pts):
            take = min(batch_size, len(block_pts))
            pts = np.stack(block_pts[:take])
            seg = np.stack(block_seg[:take])
            w = np.stack(block_w[:take])
            del block_pts[:take], block_seg[:take], block_w[:take]
            pad = batch_size - take
            if pad:
                pts = np.concatenate([pts, pts[-1:].repeat(pad, 0)])
                seg = np.concatenate([seg, seg[-1:].repeat(pad, 0)])
                w = np.concatenate([w, w[-1:].repeat(pad, 0)])
            batch = {"points": pts.astype(np.float32), "seg": seg,
                     "smpw": w}
            pred = np.asarray(eval_logits_fn(batch)).argmax(-1)
            metrics.update(pts[:take], pred[:take], seg[:take], w[:take])

    for ps, seg, w in whole_scene_dataset.blocks():
        block_pts.append(ps)
        block_seg.append(seg)
        block_w.append(w)
        flush()
    flush(force=True)
    return metrics.allreduced().result(log_fn, prefix="eval whole scene")


def make_scannet_eval_protocol(chopped_dataset, whole_scene_dataset=None,
                               batch_size: int = 16, seed: int = 0):
    """Best-checkpoint selection protocol for ``Trainer.fit``
    (scannet/train.py:167-174): on the eval cadence run the random-crop
    evaluation and the whole-scene one, and score the epoch by the
    whole-scene calibrated voxel accuracy (the crops' when there is no
    whole-scene set). Returns protocol(trainer, state, epoch) -> score."""
    rng = np.random.default_rng(seed)

    def protocol(trainer, state, epoch: int) -> float:
        logits_fn = trainer.eval_logits_fn(state)
        chopped = evaluate_scannet_chopped(
            logits_fn, chopped_dataset, rng=rng, log_fn=trainer.log)
        trainer.log_metrics(epoch=epoch, split="eval_chopped", **chopped)
        if whole_scene_dataset is None:
            return chopped["calibrated_accuracy_vox"]
        whole = evaluate_scannet_whole_scene(
            logits_fn, whole_scene_dataset, batch_size=batch_size,
            log_fn=trainer.log)
        trainer.log_metrics(epoch=epoch, split="eval_whole_scene", **whole)
        return whole["calibrated_accuracy_vox"]

    return protocol
