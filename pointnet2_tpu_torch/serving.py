"""Bucketed inference endpoint on the card.

Port of pointnet2_tpu/serving.py:42-337:

- parameters and BN statistics live on the device;
- requests of any batch size are padded up to a fixed set of bucket sizes
  with replicas of row 0, and oversized requests run in chunks of the
  largest bucket;
- activations run in bfloat16 by default (float32 parameters, float32
  logits out);
- ``predict_votes`` applies the reference's vote-ensembling protocol
  (per-vote point-order shuffle + up-axis rotation, summed logits —
  evaluate.py:126-141). By default the batch is uploaded once with the
  (V, N) permutations and the V views are built and scored on the card;
- segmentation models give per-point logits, and ``predict_scene`` labels
  every point of a whole scene through the same bucketed path;
- the one-hot part segmenter takes each cloud's category label beside it,
  padded and chunked with the points;
- ``from_checkpoint`` serves a ``Trainer`` checkpoint
  (train/checkpoint.py);
- ``num_devices=N`` (pointnet2_tpu/serving.py:60-100) keeps one replica of
  the model on each of ``cuda:0`` .. ``cuda:N-1``; buckets round up to
  multiples of N, each padded batch is cut into N row shards, each shard
  runs on its card (all launched before any is read back) and each shard
  copies its rows into its own rows of the result. With ``device="cpu"``
  the N shards run one after another on the CPU;
- a request's logits land straight in its result, allocated once with its
  final shape: page-locked host memory when the model is on a card (from
  PyTorch's caching host allocator, to which the block returns when the
  caller drops the array), ordinary memory on the CPU. Only a shard's real
  rows cross the bus, with no host copy after them. The span
  ``predictor.fetch`` counts ``pinned_rows``, the rows that landed in
  page-locked memory.

Usage::

    predictor = Predictor("pointnet2_cls_ssg", variables)  # on CUDA
    logits = predictor(points)                     # (B, 40) float32
    summed = predictor.predict_votes(points, 12)   # vote ensemble

    seg = Predictor("pointnet2_sem_seg", variables)
    logits = seg(blocks)                           # (B, 8192, 21) float32
    scene = seg.predict_scene(room_xyz)            # labels, logits, votes

    parts = Predictor("pointnet2_part_seg_msg_one_hot", variables)
    logits = parts(clouds, cls_label)              # (B, 2048, 50) float32

    trained = Predictor.from_checkpoint("pointnet2_cls_ssg", "log",
                                        num_point=1024, name="best")
"""

from __future__ import annotations

import copy
from collections.abc import Sequence

import numpy as np
import torch

from pointnet2_tpu_torch import config
from pointnet2_tpu_torch.convert import flax_to_torch
from pointnet2_tpu_torch.models import get_spec
from pointnet2_tpu_torch.utils.profiling import span

_DEFAULT_BUCKETS = (1, 4, 16, 64)


def _rotate_y(batch: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate (V, B, N, C) views about the up axis, view v by angles[v]
    (points @ R_y, normal-aware for 6+ channels; the device counterpart of
    data/augment.rotate_point_cloud_by_angle)."""
    c, s = torch.cos(angles), torch.sin(angles)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([torch.stack([c, z, s], -1),
                     torch.stack([z, o, z], -1),
                     torch.stack([-s, z, c], -1)], dim=-2)  # (V, 3, 3)
    parts = [torch.einsum("vbnc,vcd->vbnd", batch[..., 0:3], R)]
    if batch.shape[-1] >= 6:
        parts.append(torch.einsum("vbnc,vcd->vbnd", batch[..., 3:6], R))
        parts.append(batch[..., 6:])
    else:
        parts.append(batch[..., 3:])
    return torch.cat(parts, dim=-1)


class Predictor:
    """An inference endpoint for a registered model.

    Parameters
    ----------
    model_name: a MODEL_REGISTRY key (reference-compatible model names).
    variables: the weights, as the port's state_dict or as a Flax
        ``{"params", "batch_stats"}`` tree (converted by
        ``convert.flax_to_torch``). None keeps the model's own Xavier
        initialisation from ``seed``.
    dtype: activation dtype (bfloat16 default; None or float32 for f32;
        parameters stay float32).
    buckets: allowed padded batch sizes. Requests pad to the smallest
        bucket that fits; larger requests run in chunks of the largest.
    device: CUDA by default; without a card that raises. ``"cpu"`` runs the
        plain PyTorch versions of the kernels.
    num_devices: shard each padded batch over this many cards (replicas on
        ``cuda:0`` .. ``cuda:N-1``; fewer cards raise), bucket sizes rounded
        up to multiples of it; on the CPU the shards run in turn.
    model_kwargs: forwarded to the model constructor (e.g. num_classes).
    """

    def __init__(self, model_name: str, variables=None, *,
                 dtype=torch.bfloat16,
                 buckets: Sequence[int] = _DEFAULT_BUCKETS, device="cuda",
                 seed: int = 0, num_devices: int = 1, **model_kwargs):
        spec = get_spec(model_name)
        self.task = spec.task
        self.model_name = model_name
        self.device = config.check_device(device)
        if num_devices < 1:
            raise ValueError(f"num_devices must be at least 1, got "
                             f"{num_devices}")
        if num_devices > 1:
            # every padded batch shards over the devices
            buckets = [-(-b // num_devices) * num_devices for b in buckets]
            if self.device.type == "cuda":
                if num_devices > torch.cuda.device_count():
                    raise ValueError(
                        f"num_devices={num_devices} on a host with "
                        f"{torch.cuda.device_count()} card(s)")
                self.device = torch.device("cuda", 0)
        self.num_devices = num_devices
        self._buckets = tuple(sorted(set(buckets)))
        model = spec.cls(dtype=dtype, device=self.device, seed=seed,
                         **model_kwargs)
        if variables is not None:
            if "params" in variables:
                variables = flax_to_torch(variables, model)
            model.load_state_dict(variables, strict=True)
        self._model = model.eval()
        # one replica a shard: a copy on each further card; on the CPU the
        # one model serves every shard
        self._replicas = [self._model] + [
            copy.deepcopy(self._model).to(torch.device("cuda", i))
            if self.device.type == "cuda" else self._model
            for i in range(1, num_devices)]

    @property
    def model(self) -> torch.nn.Module:
        return self._model

    # -- batching ----------------------------------------------------------

    def _bucket_for(self, b: int) -> int:
        for size in self._buckets:
            if b <= size:
                return size
        return self._buckets[-1]

    def _pad(self, a: np.ndarray) -> np.ndarray:
        """Pad a batch to its bucket with replicas of row 0 (real data keeps
        every path numerically busy; outputs are sliced off)."""
        b = a.shape[0]
        bucket = self._bucket_for(b)
        if b == bucket:
            return a
        pad = np.broadcast_to(a[:1], (bucket - b,) + a.shape[1:])
        return np.concatenate([a, pad], axis=0)

    def _padded_rows(self, b: int) -> int:
        """The rows ``b`` rows run as: each chunk of the largest bucket or
        less padded to its bucket."""
        top = self._buckets[-1]
        rest = b % top
        return b - rest + (self._bucket_for(rest) if rest else 0)

    @torch.inference_mode()
    def _run_padded(self, points: np.ndarray, cls_label: np.ndarray | None,
                    out: torch.Tensor) -> np.ndarray:
        """Run up to the largest bucket's rows, padded to their bucket, and
        copy each shard's real rows straight into its rows of ``out``, the
        (b, ...) float32 rows these land in; returns them as numpy."""
        b = points.shape[0]
        inputs = [points] if cls_label is None else [points, cls_label]
        n = len(self._replicas)
        shard = self._bucket_for(b) // n
        outs = []
        for i, model in enumerate(self._replicas):
            dev = next(model.parameters()).device
            with span("predictor.upload", rows=shard):
                if i == 0:
                    inputs = [self._pad(a) for a in inputs]
                args = [torch.from_numpy(np.ascontiguousarray(
                    a[i * shard:(i + 1) * shard])).to(dev) for a in inputs]
            with span("predictor.forward"):
                outs.append(model(*args).float())
        pinned = out.is_pinned()
        for i, o in enumerate(outs):
            lo, hi = min(i * shard, b), min((i + 1) * shard, b)
            with span("predictor.fetch") as s:
                if hi > lo:
                    # the bucket's padding is sliced off on the card
                    out[lo:hi].copy_(o[:hi - lo], non_blocking=True)
                    if o.is_cuda:
                        torch.cuda.current_stream(o.device).synchronize()
                s.add(pinned_rows=hi - lo if pinned else 0)
        with span("predictor.assemble"):
            return out.numpy()

    def __call__(self, points, cls_label=None) -> np.ndarray:
        """points: (B, N, C) float; cls_label: (B,) int, the object
        category, for a ``part_seg_one_hot`` model (ignored by the others).
        Returns float32 logits, (B, K) for a classifier and (B, N, K) for a
        segmentation model.

        The result is allocated once, with its final shape, and every
        shard of every chunk copies its real rows straight into its own
        rows of it. With the model on a card it is page-locked host memory
        from PyTorch's caching host allocator: the copy out runs at the
        bus's rate, and the block returns to that cache when the caller
        drops the array, to be handed out again with no new allocation.
        Each call returns memory of its own: no later call writes it.

        Spans (utils/profiling.py, while a profiler records):
        ``predictor.request`` (counts ``rows`` and ``padded_rows``, the
        rows with their bucket's padding) around ``predictor.upload`` (pad,
        copy to the card, a shard at a time, count ``rows``),
        ``predictor.forward`` (the host's dispatch of the model),
        ``predictor.fetch`` (the wait for the card and the copy of a
        shard's real rows into the result; counts ``pinned_rows``, the rows
        that landed in page-locked memory: all of them on a card, none on
        the CPU) and ``predictor.assemble`` (the result handed out, once a
        run and once more around a chunked request)."""
        points = np.asarray(points, np.float32)
        b = points.shape[0]
        with span("predictor.request", rows=b,
                  padded_rows=self._padded_rows(b)):
            if self.task == "part_seg_one_hot":
                if cls_label is None:
                    raise ValueError("part_seg_one_hot needs cls_label")
                cls_label = np.asarray(cls_label, np.int32)
                if cls_label.shape != (b,):
                    raise ValueError(f"cls_label must be ({b},), got "
                                     f"{cls_label.shape}")
            else:
                cls_label = None
            per_point = () if self.task == "cls" else points.shape[1:2]
            shape = (b, *per_point, self._model.num_classes)
            if b == 0:
                return np.zeros(shape, np.float32)
            out = torch.empty(shape, dtype=torch.float32,
                              pin_memory=self.device.type == "cuda")
            max_bucket = self._buckets[-1]
            if b <= max_bucket:
                return self._run_padded(points, cls_label, out)
            for s in range(0, b, max_bucket):
                self._run_padded(points[s:s + max_bucket],
                                 None if cls_label is None
                                 else cls_label[s:s + max_bucket],
                                 out[s:s + max_bucket])
            with span("predictor.assemble"):
                return out.numpy()

    def predict_proba(self, points, cls_label=None) -> np.ndarray:
        logits = self(points, cls_label)
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    @torch.inference_mode()
    def _vote_apply(self, pts: torch.Tensor, perms: torch.Tensor):
        """Build the V shuffled+rotated views of an uploaded (B, N, C) batch
        on the device from (V, N) permutations, score them in one model
        call, and sum the logits over votes."""
        V = perms.shape[0]
        B = pts.shape[0]
        angles = (torch.arange(V, dtype=torch.float32, device=pts.device)
                  / V * 2.0 * float(np.float32(np.pi)))
        views = _rotate_y(pts[:, perms].transpose(0, 1), angles)  # (V,B,N,C)
        stacked = views.reshape((V * B,) + tuple(views.shape[2:]))
        logits = self._model(stacked).float()
        return logits.reshape(V, B, -1).sum(dim=0)

    def predict_votes(self, points, num_votes: int = 12, rng=None,
                      on_device: bool = True) -> np.ndarray:
        """Vote-ensembled logits (float64) for classification models: per
        vote, shuffle the point order (diversifies FPS) and rotate about
        the up axis by vote/num_votes * 2pi, then sum.

        Default (`on_device=True`, one device): the batch is padded to a
        bucket and uploaded once with the (V, N) permutations; views, model
        and the vote sum run on the card. With `on_device=False` (or with
        ``num_devices`` > 1) the V views are stacked on the host and stream
        through the bucketed path, sharded over the devices. Both
        draw one ``rng.permutation(N)`` per vote, in order."""
        from pointnet2_tpu_torch.evaluation.cls_vote import vote_logits

        if self.task != "cls":
            raise ValueError("vote ensembling is a classification protocol")
        pts = np.asarray(points, np.float32)
        rng = rng if isinstance(rng, np.random.Generator) else \
            np.random.default_rng(rng)
        if not on_device or self.num_devices > 1 or pts.shape[0] == 0:
            return vote_logits(self, pts, num_votes, rng)
        B, N = pts.shape[:2]
        perms = torch.from_numpy(
            np.stack([rng.permutation(N) for _ in range(num_votes)])).to(
                self.device)
        out = []
        max_bucket = self._buckets[-1]
        for s in range(0, B, max_bucket):
            part = pts[s:s + max_bucket]
            b = part.shape[0]
            x = torch.from_numpy(self._pad(part)).to(self.device)
            summed = self._vote_apply(x, perms)
            out.append(summed.cpu().numpy().astype(np.float64)[:b])
        return np.concatenate(out, axis=0)

    def predict_scene(self, points, npoints: int = 8192,
                      seed: int = 0) -> dict:
        """Segment a whole scene, (n, C) points with xyz first, through the
        bucketed fixed-shape path (pointnet2_tpu/serving.py:228-293).

        The scene is tiled into 1.5 m columns with 0.2 m overlap
        (``data.scannet.block_members``). Every member point is scored:
        each block's members are shuffled, padded to a multiple of
        `npoints` with rows drawn from the block, and chunked. Overlap
        points get logit votes from up to 4 blocks, summed before the
        argmax. The draws from ``default_rng(seed)`` (a shuffle per block,
        then its pad) are the JAX package's, in its order, so the chunks
        and the votes are the same.

        Returns {"labels" (n,) int32, "logits" (n, K) float32, "votes" (n,)
        int32, the number of blocks that scored each point}.
        """
        if self.task != "sem_seg":
            raise ValueError("predict_scene is for sem_seg models")
        from pointnet2_tpu_torch.data.scannet import block_members

        pts = np.asarray(points, np.float32)
        n = len(pts)
        if n == 0:
            return {"labels": np.zeros(0, np.int32),
                    "logits": np.zeros((0, 0), np.float32),
                    "votes": np.zeros(0, np.int32)}
        rng = np.random.default_rng(seed)
        coordmin, coordmax = pts.min(axis=0), pts.max(axis=0)
        nx = int(np.ceil((coordmax[0] - coordmin[0]) / 1.5)) or 1
        ny = int(np.ceil((coordmax[1] - coordmin[1]) / 1.5)) or 1
        pairs = block_members(pts, coordmin, nx, ny)
        _, starts = np.unique(pairs[:, 0], return_index=True)
        ends = np.append(starts[1:], len(pairs))

        chunks = []  # (member-index chunk, valid count)
        for s, e in zip(starts, ends):
            member = pairs[s:e, 1].copy()
            rng.shuffle(member)
            for off in range(0, len(member), npoints):
                chunk = member[off:off + npoints]
                valid = len(chunk)
                if valid < npoints:  # pad from the block (votes ignored)
                    extra = member[rng.integers(len(member),
                                                size=npoints - valid)]
                    chunk = np.concatenate([chunk, extra])
                chunks.append((chunk, valid))

        logit_sum = None
        votes = np.zeros(n, np.int32)
        max_bucket = self._buckets[-1]
        for s in range(0, len(chunks), max_bucket):
            group = chunks[s:s + max_bucket]
            batch = np.stack([pts[c] for c, _ in group])
            logits = self(batch)  # (B, npoints, K) via the bucketed path
            if logit_sum is None:
                logit_sum = np.zeros((n, logits.shape[-1]), np.float32)
            for (chunk, valid), lg in zip(group, logits):
                np.add.at(logit_sum, chunk[:valid], lg[:valid])
                np.add.at(votes, chunk[:valid], 1)
        return {"labels": logit_sum.argmax(-1).astype(np.int32),
                "logits": logit_sum, "votes": votes}

    # -- construction ------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, model_name: str, ckpt_dir: str, *,
                        num_point: int, in_channels: int = 3,
                        name: str = "ckpt", optimizer: str = "adam",
                        **kwargs) -> "Predictor":
        """Serve checkpoint ``name`` of a ``Trainer`` run in ``ckpt_dir``:
        its model ``state_dict`` loads into a Predictor built with
        ``kwargs`` (``dtype``, ``buckets``, ``device``: CUDA unless
        ``device="cpu"``, ``num_devices``, model kwargs). ``num_point``, ``in_channels``
        and ``optimizer`` describe the training run as in the JAX
        package's signature, which needs them for its restore template;
        the torch format stores the state itself and needs none."""
        from pointnet2_tpu_torch.train.checkpoint import read_checkpoint

        del num_point, in_channels, optimizer  # no template to build
        saved = read_checkpoint(ckpt_dir, name)
        return cls(model_name, saved["model"], **kwargs)
