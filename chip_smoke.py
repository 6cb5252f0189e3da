#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``pointnet2_tpu_torch``).

Drives the port's paths at full width on one NVIDIA GPU through its
thirteen hand-written CUDA kernels (FPS, ball query, ball query with grouped
xyz, multi-radius ball query, row gather, row scatter-add, three-NN, the
fused SA chain's dense pass, pooled tail and affine tail, and the chain's
backward: the top BN's totals, the dense backward and the leading BN's
backward):
classifier serving, ``Predictor("pointnet2_cls_ssg")`` (1024 points, 40
classes, buckets 1/4/16/64, bf16 and f32, 12-vote ``predict_votes``);
training, ``Trainer.fit`` (batch 16, 1024 points, on-device augmentation,
Adam); segmentation serving, ``Predictor("pointnet2_sem_seg")`` (8192-point
ScanNet blocks, 21 classes, and ``predict_scene`` on a whole room) and
``Predictor("pointnet2_part_seg")`` (2048 points with normals, 50 parts);
and multi-scale grouping, ``Predictor("pointnet2_cls_msg")``,
``Predictor("pointnet2_part_seg_msg_one_hot")`` (with category labels) and
``Predictor("pointnet_cls_basic")``, with the MSG layers' unfused layout and
the multi-radius ball query; the fused SA chain (``config.fused_mlp``)
through ``Predictor`` for the five models with fused-eligible SA layers;
the fused chain in train mode through ``Trainer.fit`` of
``pointnet2_cls_ssg`` and ``pointnet2_cls_msg``; and segmentation training,
``Trainer.fit`` of ``pointnet2_sem_seg`` on ``ScannetDataset`` crops of
generated rooms (8192 points, the wdp input dropout, ``augment="scannet"``),
``pointnet2_part_seg`` and ``pointnet2_part_seg_msg_one_hot`` on
``SyntheticShapeNetPart`` (2048 points with normals, category labels);
checkpoints with exact resume and ``Predictor.from_checkpoint``; the vote,
part-mIoU and ScanNet evaluation protocols; the train and evaluate CLIs;
the trainer's switches: ``steps_per_call`` as one CUDA graph of K train
steps, ``remat``, the stall watchdog under ``cli.supervise``, and
``--normal`` on the ModelNet txt data with the host augmentation; scale-out
over ranks; the procedural stand-ins with ``--virtual_scan``; and the rest
of the surface: mesh sampling, the layer zoo, the parity-day rehearsal
through ``data.ingest``, ``cli.visualize``, the three demos and the
profiling helpers; and FPS at any cloud size, on its thread-block-cluster
route above 16384 points. Phases:

1. build the kernels from ``pointnet2_tpu_torch/csrc/`` with nvcc, one
   process per source, all at once; log ``ptxas -v`` of ``ball_query.cu``,
   ``scatter.cu``, ``three_nn.cu`` and ``fused_mlp.cu`` (and check that no
   kernel of ``ball_query.cu`` has a stack frame or spills), and check in the
   built library's SASS that the bf16 dense pass's product and the bf16
   dense backward's two run on the tensor cores (HMMA) and the f32 ones do
   not;
2. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes, B=16 and B=768 (12 votes x bucket 64): FPS and
   ball-query outputs bit-identical, gathers bitwise equal; and FPS and
   the ball query at sem_seg SA1's shape (B=16, 8192 -> 1024; r=0.1,
   nsample 32, on the generated room's columns of phase 11),
   bit-identical;
3. serve batches of 1, 16, 64 and 100 in bf16 and f32 and a 12-vote call,
   with every launch counter set to 0 just before and read just after;
   compare the logits with the same requests forced to the plain versions
   on the card, with the CPU on a small batch, and bf16 with f32;
4. check ``predict_votes(num_votes=12)`` at B=16: finite, (16, 40), and
   the same for the same seed;
5. time each kernel, its plain version and (for the gather) one PyTorch
   call computing the same function, FPS and the ball query also at
   sem_seg SA1's shape (µs a selection step, µs a query), the serving
   forward and the vote call, and break a bf16 forward's device time down
   by kernel;
6. hold the scatter-add kernel bit for bit against its plain version on
   CPU copies of the same inputs at the train path's shapes (the backward
   of the SA1 and SA2 gathers at B=16, f32 and bf16), at sem_seg SA1's
   (n=8192, K=1024*32), at C=3 and C=5, on a hot row, out-of-range
   indices and K=0, its CSR equal to the plain CSR, and check that two
   launches give the same bits;
7. one full-width train step through the kernels and through the plain
   versions on the card, from the same weights, batch and generator seed:
   loss, gradients and running statistics, f32 and bf16; and whether two
   runs of the kernel path give the same bits;
8. train with ``Trainer.fit`` (synthetic 40-class clouds, 1024 points,
   batch 16, ``augment="cls"``, bf16 and f32) with every launch counter set
   to 0 just before and read just after; the loss must fall; the trained
   weights then serve through ``Predictor.predict_votes``;
9. time the train step (ms/step, examples/s, device busy share, device
   time by host op, peak memory) and the scatter kernel per launch beside
   its bound, its plain version and ``Tensor.index_add_``;
10. hold the three-NN kernel against its plain version, bit for bit, at
    every FP shape of the two segmentation models at B=16 (part_seg's FP1
    has one known point), and check that two launches give the same bits;
    and on ties: a known set repeated at a stride of 13 (the walk with a
    bit a known point) and of 7 (the direct walk), at one and two unknown
    points a thread, so that an unknown point's nearest copies lie at equal
    distances in one batch of the bit walk and in two;
11. serve sem_seg (requests of 1, 16, 64 and 100 blocks, and
    ``predict_scene`` on a generated room of 100000 points, 6 x 5 m) and
    part_seg (16 and 64 clouds) in bf16 and f32, each model's run with
    every launch counter set to 0 just before and read just after;
    compare with the plain versions on the card at B <= 16, with the CPU
    on 2 inputs, and ``predict_scene`` kernel vs plain in f32;
12. time three-NN per launch beside its bound (which counts the points
    each unknown point's scan inserts), its plain version, ``cdist`` +
    ``topk`` and, where the launch takes two unknown points a thread, the
    same launch with one; ``three_interpolate``, the seg forwards at B=16
    and 64, ``predict_scene``, peak memory, and a bf16 B=16 forward's
    device time by op.
13. hold the ball query with grouped xyz (idx and cnt bit for bit, the
    coordinates equal by value to the plain version and to xyz1[idx]) and
    the multi-radius ball query (each radius bit for bit against the ball
    query kernel and the plain version) at every MSG ball-query shape of
    cls_msg and part_seg_msg at B=16, and the grouped-xyz backward (one
    scatter launch, bit for bit the plain scatter on CPU copies);
14. serve cls_msg (requests of 1, 16, 64, 100 and a 12-vote request of
    16), part_seg_msg (16 and 64 clouds with labels) and cls_basic (16) in
    bf16 and f32, each model's run with every launch counter set to 0 just
    before and read just after; then, from the counters' zero, cls_msg's
    two MSG layers rebuilt with ``fuse_first=False`` on the model's own
    weights (held to the fused layers) and the multi-radius query at every
    MSG layer's radius set; compare with the plain versions on the card at
    B <= 16 and with the CPU on 2 inputs;
15. time both new kernels per launch beside their bounds, their plain
    versions and the launches of the default path they stand for (the ball
    query plus the xyz gather; the per-radius ball queries), the grouped-xyz
    query beside the bare ball query at the same shapes, the MSG
    forwards at B=16 and 64, peak memory, and a bf16 B=16 forward's device
    time by op;
16. hold the fused chain's three kernels against their plain versions at
    every fused chain of the five models at B=16 (their own weights and BN
    statistics, random inputs), f32 and bf16, and at a ragged shape (1000
    rows, 196 -> 40): the dense pass within 1e-5 of max|y| of plain in
    f32 and, in bf16, within one bf16 ulp of the exact product of its
    rounded operands plus the f32 accumulation bound (`y_ok`), its column
    statistics within 1e-4 of sum|terms| of their exact (float64) sums and
    bit for bit across two launches; the pooled and affine tails bit for
    bit, and the affine tail also on inputs one element into their storage
    (the element-by-element route) at the ragged shape and at 131 channels;
17. serve cls_ssg, cls_msg, sem_seg, part_seg and part_seg_msg (with
    labels) with ``config.fused_mlp(True)``, requests of 16 and 64 in bf16
    and f32, each model's run with every launch counter set to 0 just
    before and read just after; compare with the plain versions on the card
    and with the unfused route at B=16 (f32 within 1e-4 of the range, bf16
    within 2%), and with the CPU on 2 inputs;
18. time the three kernels per launch at a bf16 cls_ssg forward's shapes
    beside their bounds, their plain versions and the unfused PyTorch ops
    each stands for (and the dense pass beside the bare bf16 ``addmm`` of
    its rounded operands); the fused and unfused forwards of the five
    models at B=16 and 64 in bf16 and f32 (host ms, device time, peak
    memory); and a fused bf16 B=16 forward's device time by op;
19. hold the chain's backward kernels against their plain versions along
    every fused chain of the five models at B=16 (the models' own BN
    scales and biases, random pre-BN activations and cotangents, batch
    statistics), bf16 and f32, each kernel on the previous one's outputs,
    and along a ragged chain (1000 rows, 196 -> 40, groups of 8): the top
    BN's totals, dW, db and the T1/T2 of the kernel's own g_{k-1} within
    1e-4 of sum|terms| of the exact (float64) sums of the plain version's
    terms, g_{k-1} within 1e-5 of max|g| of plain (f32) or, in bf16,
    within one bf16 ulp of the exact product of its rounded operands plus
    the f32 accumulation bound (`g_ok`), the leading BN's dx bit for bit,
    every kernel bitwise equal across two launches; and the top BN's
    totals on inputs where only the first-occurrence argmax passes (tied z
    over rows whose y differ, NaNs before and after a channel's max) at
    cls_ssg SA2's top shape and a ragged one;
20. one full-width cls_ssg train step with the gate on through the
    kernels, the plain versions and the unfused route, each f32 route
    against a float64 run of the same step (fixed dropout masks, no
    augmentation); cls_ssg's two fused layers in train mode, kernels
    against plain on the same inputs and cotangents, f32 and bf16 (outputs,
    gradients, running statistics); the launches of one fused step; then,
    from the counters' zero, ``Trainer.fit`` of cls_ssg and of cls_msg in
    bf16 with the gate on:
    the loss must fall and each step launch 1 top_stats, 2 dense_bwd and 1
    first_bwd per chain (2 chains a cls_ssg step, 6 a cls_msg step);
21. time the backward kernels per launch at a cls_ssg train step's shapes
    beside their bounds and plain versions (and the dense backward beside
    the two bare bf16 ``torch.mm`` products), each chain's backward fused
    against the unfused autograd backward of the same layer, the train
    steps of cls_ssg and cls_msg fused and unfused at B=16 in bf16 and f32
    (ms/step, examples/s, device time, peak memory), and a fused bf16
    cls_ssg step's device time by op;
22. one full-width train step of sem_seg (B=16, a ScanNet crop of 8192
    points with its wdp-zeroed weights, the z rotation), part_seg and
    part_seg_msg (B=16, 2048 points with normals, category labels) through
    the kernels and through the plain versions on the card, f32 and bf16:
    loss and running statistics equal, gradients within 1e-4 (f32) or 0.5
    (bf16, the median tensor's within 2e-2) of their scales, every scatter
    of the kernel path's step bit for bit its plain version on CPU copies
    of its cotangent rows and indices; then sem_seg's step with
    ``config.fused_mlp`` on, kernels against plain versions, f32 (loss
    1e-5, statistics 1e-3, gradients 2e-2) and bf16 (loss 1e-2,
    statistics 5e-2, gradients logged), the chain's kernels launched for
    each of its four SA layers, and those four layers on the step's crop,
    kernels against plain versions within phase 20's layer limits;
23. train with ``Trainer.fit`` (batch 16, Adam lr 1e-3, 4 epochs of 3
    steps): sem_seg on ScanNet crops of 48 generated rooms (eval: 16
    others), part_seg and part_seg_msg on 48 synthetic part clouds (eval:
    16 others), each in bf16 and f32, and sem_seg in bf16 with
    ``config.fused_mlp`` on, each run with every launch counter set to 0
    just before and read just after; the train loss must fall, the eval's
    per-point accuracy be logged, and every forward launch its path's FPS,
    ball query and three-NN kernels;
24. time the segmentation train steps at B=16 in bf16 and f32 (and
    sem_seg bf16 with the gate off and on): ms/step, examples/s, device
    us/step, the card's idle share of the step, peak memory; and a bf16
    sem_seg step's device time by op.
25. checkpoints and exact resume: ``Trainer.fit`` of cls_ssg (B=16,
    augment "cls", dropout on) for 2 epochs, stopped, and resumed to 4 by a
    new ``Trainer`` on the same log_dir, in f32 and in bf16 with
    ``config.fused_mlp`` on, against two uninterrupted 4-epoch runs:
    parameters, BN statistics, optimizer moments, count, step and the
    generator bit for bit (or, if the uninterrupted runs differ, within
    their spread, the tensors named); a better best checkpoint kept through
    the resumed evals; ``Predictor.from_checkpoint``'s logits equal to the
    trainer's eval-mode model's; save and restore ms and the checkpoint's
    MiB;
26. the evaluation protocols through ``Trainer.eval_logits_fn`` on seeded
    weights: ``evaluate_cls_voting`` (12 votes, 80 clouds),
    ``evaluate_part_seg_voting`` (12 votes, 32 part clouds of 2048 points
    with normals) and ``evaluate_scannet_chopped`` and ``..._whole_scene``
    (8192 points, B=16, four generated rooms of 100000 points), each
    through the kernels, with every counter from 0, and under
    ``config.default_impl("torch")``: f32 metric dicts equal, bf16 logged;
    wall time, inputs/s and the shares of forwards and metric code;
27. the CLI journey in this process: ``cli.train`` and ``cli.evaluate
    --out`` of cls_ssg (synthetic, 2 epochs, 12 votes) and sem_seg
    (synthetic, 8192 points, 1 epoch, the whole-scene protocol, 2 loader
    threads): checkpoints, sidecars, ``metrics.jsonl`` and the record as
    the JAX package writes them, and FPS, the ball query, the gather, the
    scatter and three_nn launched;
28. ``steps_per_call=4``: an epoch of ``Trainer.train_epoch`` whose
    K-step calls are one CUDA graph replay each (the remainder single
    steps) against the same epoch of single steps, bf16: cls_ssg at B=16
    and 32 with the fused chain off and on, sem_seg at B=16 on 8192-point
    crops; parameters, BN statistics, moments, count, step and generator
    bit for bit, a replay's launches 4 single steps', the epoch's its
    steps' and the warm-up's; ms/step, examples/s, device time a step,
    the idle share and peak memory of a single step (on a batch on the
    card, and uploading it) and of the graph (and its pool), the capture's
    time; and 2 + 2 epochs of cls_ssg (bf16, fused) with
    ``steps_per_call=4`` and a resume against 4 epochs of single steps,
    bit for bit;
29. ``remat``: two bf16 train steps at B=16 under each policy (none,
    full, dots, dots_nobatch) of cls_ssg with the fused chain off and on
    and of sem_seg: gradients, parameters, statistics, moments and the
    generator bit for bit those of ``none``; peak memory, ms/step and
    launches of each;
30. ``cli.supervise`` around a ``cli.train`` subprocess wedged at a step
    by a device sleep past its ``--watchdog_secs``: the watchdog exits it
    with 75, the supervisor restarts it, the restart resumes from its
    checkpoint and ends; and ``cli.train --normal`` on a generated ModelNet
    txt tree, and ``Trainer.fit`` on it with ``host_augment``.
31. scale-out (``parallel.launch``, ``torch.distributed``): (a) two gloo
    ranks sharing cuda:0, one train step each of cls_ssg at global B=32
    (N=1024; f32 and bf16, the fused chain off and on, and float64 on the
    plain versions) and of sem_seg at B=32 (N=8192, bf16), against one
    process's step on the same global batch: the ranks bit-identical to
    each other, loss, running statistics and gradients within
    ``SCALE_TOL``, the eval counts summed over the ranks equal; (b) one NCCL rank: ``Trainer(num_devices=1)`` with
    ``steps_per_call=4`` (the graph capturing the step's collectives),
    fused bf16 cls_ssg, an epoch of 6 batches, bit for bit the trainer
    without a group, and ``Predictor(num_devices=1)`` bit for bit today's;
    (c) where the machine has N >= 2 cards: (a)'s steps on N NCCL ranks at
    global B=16N, ``cli.train --num_devices N`` and ``cli.evaluate`` on its
    checkpoint, ``Predictor(num_devices=N)`` against one card, and weak
    scaling at 1, 2 and N ranks (examples/s, efficiency, the gradient
    all-reduce's time, the collectives' share of a step's device time).
32. the procedural stand-ins and the virtual scan: (a) the ModelNet,
    ShapeNet-part and ScanNet generators through their ``python -m`` entry
    points in subprocesses (2 train / 1 test shapes a class in the txt
    layout with normals, and in HDF5 where h5py imports; 1 / 1 / 1 part
    shapes a category; 3 train / 2 test rooms), each layout through the
    port's reader; (b) ``cli.train --model pointnet2_sem_seg
    --virtual_scan --dtype bfloat16`` on those rooms (8192 points, B=8, 2
    epochs, the chopped and whole-scene protocols each epoch) and
    ``cli.evaluate --ckpt best``, every counter from 0: finite losses, the
    metrics JSON as JAX's, FPS, the ball query, the gather, the scatter
    and three_nn launched; (c) one bf16 sem_seg train step on a
    virtual-scan batch through the kernels and the plain versions, held
    as phase 22 holds its steps.
33. the rest of the surface: (a) ``ops.sample_mesh`` (area-weighted
    triangle picks by ``prob_sample``, the corner gather, FPS to 1024) on
    the icosahedron of the mesh demo and on 16 meshes of 2000 triangles,
    8192 draws each, through the kernels and through the plain versions on
    the same uniforms: dense draws and reduced points exact, FPS indices
    bit for bit, and ``prob_sample`` on the card against the CPU; (b) the
    conv/pool layer zoo (``nn.extras``) on the card against the CPU in
    f32; (c) the dress rehearsal: miniature ModelNet40 (txt layout),
    ShapeNet-part and ScanNet zips through ``data.ingest``, ``cli.train``
    and ``cli.evaluate`` of cls_ssg, part_seg_msg_one_hot and sem_seg;
    (d) ``cli.visualize`` on those checkpoints with the native ball
    renderer (built by g++); (e) the three demos (mesh sampling,
    interpolation, whole-scene inference on a room generated for 80-100k
    points) with
    ``--device cuda``, PNGs under ``chiprun_out/phase33/``; (f)
    ``utils.profiling``: ``time_op_loop`` of the gather beside CUDA events,
    and ``trace``'s Chrome trace in a fresh process (and, logged, in this
    one: late in a full run the profiler loses kernels, erratically);
34. FPS at any cloud size: the CTA route's edge (16, 16384 -> 1024), the
    cluster route (16385 to 262144 points: two whole generated ScanNet
    rooms thinned to 8192, four clouds of 50000) and its scratch route
    (262145 and 1000000 points), a lattice and a far point copied across
    slices (ties), 40000 identical points, each through
    ``farthest_point_sample`` bit for bit ``fps_plain`` with one launch,
    and timed (µs a step beside sem_seg SA1's, the plain version, the
    operations bound); ``sample_mesh`` with 100000 draws -> 10000 points
    on 16 meshes through the kernels and the plain route, exact; three_nn
    and the scatter-add at B = 65537 clouds bit for bit; ``ptxas -v`` of
    ``fps.cu``; under 60 s after the build.

Prints the GPU's name and power limit, a ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Exits non-zero, without that line,
if any phase fails, if there is no CUDA device, or if the port is not
beside this script. Weights are random (Xavier-uniform dense weights and
randomised BN statistics from a seed); clouds are surface samples of
random primitives, normalised into the unit sphere as ModelNet40's are
(with their surface normals for the part segmenters, whose category
labels are drawn from the seed); ScanNet blocks are 1.5 m columns of a
generated room (floor, ceiling, walls, box furniture).

Usage (from the repository root, one GPU):  python3 chip_smoke.py
Phase 31 alone, after phase 1's build (on every card of the machine):
python3 chip_smoke.py --phase 31
Phase 32 alone, after phase 1's build:  python3 chip_smoke.py --phase 32
Phase 33 alone, after phase 1's build:  python3 chip_smoke.py --phase 33
Phase 34 alone, after phase 1's build:  python3 chip_smoke.py --phase 34
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

N_POINT = 1024
NUM_CLASSES = 40
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
# H100 SXM float32 outside the tensor cores: the data sheet's 67e12 op/s
# counts an FMA as two operations. The point kernels' squared distances
# (csrc/common.cuh sq_dist) forbid contraction, so they issue at most one
# f32 operation an instruction: half that rate.
F32_NO_FMA_OPS_PER_S = 33.5e12
# a matrix product's bound: bf16 on the tensor cores (dense), f32 as FMAs
BF16_TENSOR_OPS_PER_S = 989e12
F32_FMA_OPS_PER_S = 67e12

REPLACES = {
    "fps": "pointnet2_tpu/ops/pallas/fps.py:103",
    "ball_query": "pointnet2_tpu/ops/pallas/ball_query.py:237",
    "ball_query_group_xyz": "pointnet2_tpu/ops/pallas/ball_query.py:374",
    "ball_query_multi": "pointnet2_tpu/ops/pallas/ball_query.py:312",
    "gather_rows": "pointnet2_tpu/ops/pallas/group.py:189",
    "scatter_rows": "pointnet2_tpu/ops/pallas/group.py:227",
    "three_nn": "pointnet2_tpu/ops/pallas/three_nn.py:67",
    "fused_dense": "pointnet2_tpu/ops/pallas/fused_mlp.py:141",
    "fused_pool": "pointnet2_tpu/ops/pallas/fused_mlp.py:189",
    "fused_affine": "pointnet2_tpu/ops/pallas/fused_mlp.py:215",
    "fused_top_stats": "pointnet2_tpu/ops/pallas/fused_mlp.py:288",
    "fused_dense_bwd": "pointnet2_tpu/ops/pallas/fused_mlp.py:391",
    "fused_first_bwd": "pointnet2_tpu/ops/pallas/fused_mlp.py:478",
}
SOURCES = {
    "fps": "pointnet2_tpu_torch/csrc/fps.cu",
    "ball_query": "pointnet2_tpu_torch/csrc/ball_query.cu",
    "ball_query_group_xyz": "pointnet2_tpu_torch/csrc/ball_query.cu",
    "ball_query_multi": "pointnet2_tpu_torch/csrc/ball_query.cu",
    "gather_rows": "pointnet2_tpu_torch/csrc/gather.cu",
    "scatter_rows": "pointnet2_tpu_torch/csrc/scatter.cu",
    "three_nn": "pointnet2_tpu_torch/csrc/three_nn.cu",
    "fused_dense": "pointnet2_tpu_torch/csrc/fused_mlp.cu",
    "fused_pool": "pointnet2_tpu_torch/csrc/fused_mlp.cu",
    "fused_affine": "pointnet2_tpu_torch/csrc/fused_mlp.cu",
    "fused_top_stats": "pointnet2_tpu_torch/csrc/fused_mlp.cu",
    "fused_dense_bwd": "pointnet2_tpu_torch/csrc/fused_mlp.cu",
    "fused_first_bwd": "pointnet2_tpu_torch/csrc/fused_mlp.cu",
}
# device kernels a wrapper launches besides its `<name>_kernel`: the CSR
# passes of csrc/scatter.cu, the bf16 dense pass on the tensor cores, the
# passes of fused_dense_bwd (f32 on the CUDA cores, bf16 on the tensor
# cores), the rounding of W to bf16 both take first, and the fixed-order
# column sums of csrc/fused_mlp.cu
HELPERS = ("scatter_count", "scatter_offsets", "scatter_place",
           "fused_dense_mma", "dense_bwd_g", "dense_bwd_dw", "dense_bwd_g_mma",
           "dense_bwd_dw_mma", "round_bf16", "sum_rows")
# the kernels of rows 10 and 14's products in csrc/fused_mlp.cu: bf16 on
# the tensor cores, f32 on the CUDA cores (phase 1 reads their SASS)
MMA_KERNELS = ("fused_dense_mma_kernel", "dense_bwd_g_mma_kernel",
               "dense_bwd_dw_mma_kernel")
FMA_KERNELS = ("fused_dense_kernel", "dense_bwd_g_kernel",
               "dense_bwd_dw_kernel")
TRAIN_EPOCHS = 4  # per dtype in phase 8
# the serving path's kernel shapes: (B, N) -> npoint, then the ball query
# (radius, nsample) and the width of the lifted rows group_point moves
SA = ({"n": 1024, "npoint": 512, "radius": 0.2, "nsample": 32, "width": 64},
      {"n": 512, "npoint": 128, "radius": 0.4, "nsample": 64, "width": 128})


def log(msg: str) -> None:
    print(msg, flush=True)


def make_clouds(n_clouds: int, n_points: int, seed: int,
                normals: bool = False) -> np.ndarray:
    """Surface samples of spheres, boxes, cylinders and tori with random
    anisotropic scale, centred and normalised into the unit sphere:
    (n_clouds, n_points, 3), or with ``normals`` (n_clouds, n_points, 6)
    with the unit surface normals (scaled by the inverse scale)."""
    rng = np.random.default_rng(seed)
    out = np.empty((n_clouds, n_points, 6 if normals else 3), np.float32)
    n = n_points
    for i in range(n_clouds):
        kind = i % 4
        if kind == 0:
            p = rng.normal(size=(n, 3))
            p /= np.linalg.norm(p, axis=1, keepdims=True)
            nrm = p.copy()
        elif kind == 1:
            p = rng.uniform(-1, 1, (n, 3))
            face = rng.integers(0, 3, n)
            side = rng.choice([-1.0, 1.0], n)
            p[np.arange(n), face] = side
            nrm = np.zeros((n, 3))
            nrm[np.arange(n), face] = side
        elif kind == 2:
            t = rng.uniform(0, 2 * np.pi, n)
            p = np.stack([np.cos(t), np.sin(t), rng.uniform(-1, 1, n)], 1)
            nrm = np.stack([np.cos(t), np.sin(t), np.zeros(n)], 1)
        else:
            t, s = rng.uniform(0, 2 * np.pi, (2, n))
            ring = 1.0 + 0.35 * np.cos(s)
            p = np.stack([ring * np.cos(t), ring * np.sin(t),
                          0.35 * np.sin(s)], 1)
            nrm = np.stack([np.cos(s) * np.cos(t), np.cos(s) * np.sin(t),
                            np.sin(s)], 1)
        scale = rng.uniform(0.4, 1.0, 3)
        p = p * scale
        p -= p.mean(0)
        out[i, :, :3] = p / np.linalg.norm(p, axis=1).max()
        if normals:
            nrm = nrm / scale
            out[i, :, 3:] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    return out


def random_state_dict(torch, seed: int,
                      name: str = "pointnet2_cls_ssg") -> dict:
    """Seeded weights for a registered model: its own Xavier-uniform dense
    weights, then BN scale |s| in [0.5, 1.5] (~20% negative), BN bias,
    dense bias and running mean ~N(0, 0.1^2), running var in [0.5, 1.5],
    so that eval BN is not the identity."""
    from pointnet2_tpu_torch import get_model

    sd = get_model(name, device="cpu", seed=seed).state_dict()
    g = torch.Generator().manual_seed(seed + 1)
    for key, t in sd.items():
        if key.endswith("norm.weight"):
            sign = torch.where(torch.rand(t.shape, generator=g) < 0.2, -1.0,
                               1.0)
            t.copy_(sign * (0.5 + torch.rand(t.shape, generator=g)))
        elif key.endswith("running_var"):
            t.copy_(0.5 + torch.rand(t.shape, generator=g))
        elif key.endswith(("running_mean", "bias")):
            t.copy_(0.1 * torch.randn(t.shape, generator=g))
    return sd


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


class Checks:
    """Collects failed checks; the run fails if any failed."""

    def __init__(self):
        self.failed: list[str] = []

    def __call__(self, ok: bool, what: str) -> bool:
        log(f"  {'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            self.failed.append(what)
        return ok


def event_ms(torch, fn, reps: int, prefill: bool = False) -> float:
    """Device time per call over `reps` back-to-back calls, CUDA events.
    With `prefill`, a device-side sleep holds the stream while the host
    enqueues every call, so a short kernel is timed without the host's
    per-launch cost between launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if prefill:
        torch.cuda._sleep(20_000_000)  # ~10 ms at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median host-clock time of `fn`, which ends in a device->host copy."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kernel_inputs(torch, dev, B: int):
    """The serving path's kernel inputs for a batch of B clouds: xyz and
    FPS/ball-query outputs per SA level, and lifted rows (random normal,
    as wide as the path's first dense) in f32 and bf16."""
    from pointnet2_tpu_torch import ops

    g = torch.Generator(device=dev).manual_seed(SEED + B)
    xyz = torch.from_numpy(make_clouds(B, N_POINT, SEED + B)).to(dev)
    levels = []
    for sa in SA:
        fidx = ops.fps_kernel(xyz, sa["npoint"])
        new_xyz = ops.gather_rows_kernel(xyz, fidx)
        idx, cnt = ops.ball_query_kernel(sa["radius"], sa["nsample"], xyz,
                                         new_xyz)
        lifted = torch.randn((B, sa["n"], sa["width"]), generator=g,
                             device=dev)
        levels.append({**sa, "xyz": xyz, "fidx": fidx, "new_xyz": new_xyz,
                       "idx": idx, "cnt": cnt, "lifted": lifted})
        xyz = new_xyz
    return levels


def check_kernels(torch, dev, B: int, check: Checks, errs: dict) -> None:
    """Phase 2 at batch B: each kernel against its plain version."""
    from pointnet2_tpu_torch.ops import grouping, sampling
    from pointnet2_tpu_torch import ops

    log(f"phase 2: kernels vs plain versions on the card, B={B}")
    for lv in kernel_inputs(torch, dev, B):
        tag = f"N={lv['n']} npoint={lv['npoint']}"
        want = sampling.fps_plain(lv["xyz"], lv["npoint"])
        err = int((lv["fidx"] - want).abs().max())
        errs["fps"] = max(errs["fps"], err)
        check(torch.equal(lv["fidx"], want), f"fps {tag} bit-identical")

        widx, wcnt = grouping.ball_query_plain(lv["radius"], lv["nsample"],
                                               lv["xyz"], lv["new_xyz"])
        err = max(int((lv["idx"] - widx).abs().max()),
                  int((lv["cnt"] - wcnt).abs().max()))
        errs["ball_query"] = max(errs["ball_query"], err)
        check(torch.equal(lv["idx"], widx) and torch.equal(lv["cnt"], wcnt),
              f"ball_query {tag} r={lv['radius']} ns={lv['nsample']} "
              f"bit-identical (mean cnt {lv['cnt'].float().mean():.2f})")

        flat = lv["idx"].reshape(B, -1)
        cases = [("xyz", lv["xyz"], lv["fidx"])]
        cases += [(f"rows C={lv['width']} {dt}", lv["lifted"].to(dt), flat)
                  for dt in (torch.float32, torch.bfloat16)]
        for name, pts, ix in cases:
            got = ops.gather_rows_kernel(pts, ix)
            want = grouping.gather_rows_plain(pts, ix)
            view = torch.int16 if pts.dtype == torch.bfloat16 else torch.int32
            same = torch.equal(got.view(view), want.view(view))
            errs["gather_rows"] = max(errs["gather_rows"],
                                      float((got.float() - want.float())
                                            .abs().max()))
            check(same, f"gather_rows {name} {tuple(pts.shape)} by "
                        f"{tuple(ix.shape)} bitwise")
        del want, widx, wcnt
    torch.cuda.synchronize()


# sem_seg SA1's FPS, the longest launch on any path: (B, N) -> npoint
FPS_SEG = (16, 8192, 1024)


def fps_seg_input(torch, dev):
    B, N, _ = FPS_SEG
    return torch.from_numpy(make_clouds(B, N, SEED + 2)).to(dev)


def check_fps_seg(torch, dev, check: Checks, errs: dict) -> None:
    """Phase 2 at sem_seg SA1's shape: FPS bit-identical to its plain
    version."""
    from pointnet2_tpu_torch import ops
    from pointnet2_tpu_torch.ops import sampling

    xyz = fps_seg_input(torch, dev)
    got = ops.fps_kernel(xyz, FPS_SEG[2])
    want = sampling.fps_plain(xyz, FPS_SEG[2])
    errs["fps"] = max(errs["fps"], int((got - want).abs().max()))
    check(torch.equal(got, want), f"fps sem_seg SA1 {tuple(xyz.shape)} -> "
          f"{FPS_SEG[2]} bit-identical")


# sem_seg SA1's ball query, on the generated room's columns that phase 11
# serves: (B, N) -> npoint queries, radius, nsample
BQ_SEG = (16, 8192, 1024, 0.1, 32)


def ball_query_seg_input(torch, dev, blocks: np.ndarray):
    """sem_seg SA1's ball-query inputs: the first B blocks and their FPS
    centres, through the kernels."""
    from pointnet2_tpu_torch import ops

    B, _, npoint, _, _ = BQ_SEG
    xyz = torch.from_numpy(np.ascontiguousarray(blocks[:B, :, :3])).to(dev)
    return xyz, ops.gather_rows_kernel(xyz, ops.fps_kernel(xyz, npoint))


def check_ball_query_seg(torch, dev, blocks: np.ndarray, check: Checks,
                         errs: dict) -> None:
    """Phase 2 at sem_seg SA1's shape: the ball query bit-identical to its
    plain version on the room's columns."""
    from pointnet2_tpu_torch import ops
    from pointnet2_tpu_torch.ops import grouping

    _, _, _, r, ns = BQ_SEG
    xyz, new_xyz = ball_query_seg_input(torch, dev, blocks)
    idx, cnt = ops.ball_query_kernel(r, ns, xyz, new_xyz)
    widx, wcnt = grouping.ball_query_plain(r, ns, xyz, new_xyz)
    errs["ball_query"] = max(errs["ball_query"],
                             int((idx - widx).abs().max()),
                             int((cnt - wcnt).abs().max()))
    check(torch.equal(idx, widx) and torch.equal(cnt, wcnt),
          f"ball_query sem_seg SA1 {tuple(xyz.shape)} -> {BQ_SEG[2]} r={r} "
          f"ns={ns} on the room's columns bit-identical (mean cnt "
          f"{cnt.float().mean():.2f}, {float((cnt == ns).float().mean()):.1%}"
          " of the balls full)")


def ball_query_bound(xyz, new_xyz, idx, cnt, nsample: int) -> tuple:
    """The least time for one launch: the points each query must scan (up
    to its nsample-th hit, else all N) times 3 sub, 3 mul, 2 add and 1
    compare, at the f32 rate without FMA; xyz read once, idx and cnt
    written once."""
    last = idx[..., -1].masked_fill(cnt != nsample, xyz.shape[1] - 1)
    byts = (xyz.numel() + new_xyz.numel() + idx.numel() + cnt.numel()) * 4
    return roofline(int((last.long() + 1).sum()) * 9, byts)


def drive_main_path(torch, predictors: dict, clouds: np.ndarray) -> dict:
    """Phase 3's main-path run through the Predictor entry points; returns
    the logits by (dtype, batch) and the 12-vote sums."""
    out = {}
    for name, pred in predictors.items():
        for b in (1, 16, 64, 100):
            out[(name, b)] = pred(clouds[:b])
    out["votes"] = predictors["bf16"].predict_votes(clouds[:16], 12, rng=SEED)
    torch.cuda.synchronize()
    return out


def roofline(ops_: float, byts: float,
             rate: float = F32_NO_FMA_OPS_PER_S) -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take
    for `ops_` operations at `rate` (default: f32 without FMA) and `byts`
    bytes of device memory traffic, and which of the two it is."""
    t_ops = ops_ / rate * 1e3
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def add_time(rows: dict, name, shape, ms, plain, bound: tuple, library=None):
    """Add one launch's times and its roofline bound (ms, by) to a
    kernel's row of the table, and log them."""
    r = rows[name]
    r["ms"] += ms
    r["plain_ms"] += plain
    r["bound_ms"] += bound[0]
    r["by"][bound[1]] += bound[0]
    if library is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + library
    lib = "" if library is None else f" library {library:.6f} ms"
    log(f"  {name:<12} {shape:<44} kernel {ms:.6f} ms  plain "
        f"{plain:.6f} ms  bound {bound[0]:.6f} ms ({bound[1]}){lib}")


def fps_bound(B: int, n: int, npoint: int) -> tuple:
    """Per step and point: 3 sub, 3 mul, 2 add, 1 min, 1 compare; xyz read
    once, the indices written once."""
    return roofline(B * (npoint - 1) * n * 10, B * n * 3 * 4 + B * npoint * 4)


def time_kernels(torch, dev, gpu: str, rows: dict,
                 blocks: np.ndarray) -> None:
    """Phase 5a: per-forward kernel, plain and library times at B=16 bf16,
    and the least time the card could take for the same work; and (logged)
    FPS and the ball query at sem_seg SA1's shape."""
    from pointnet2_tpu_torch.ops import grouping, sampling

    B = 16
    levels = kernel_inputs(torch, dev, B)

    def add(*args, **kwargs):
        add_time(rows, *args, **kwargs)

    log(f"phase 5: kernel times at B=16 on {gpu} (per launch, CUDA events; "
        "kernel and library with the queue pre-filled, plain with the host in "
        "the loop)")
    for lv in levels:
        xyz, n, npoint = lv["xyz"], lv["n"], lv["npoint"]
        out = torch.empty_like(lv["fidx"])
        ms = event_ms(torch, lambda: sampling.launch_fps(xyz, out), 20,
                      prefill=True)
        plain = event_ms(torch, lambda: sampling.fps_plain(xyz, npoint), 3)
        add("fps", f"({B},{n},3)->{npoint}", ms, plain,
            fps_bound(B, n, npoint))
        log(f"  fps latency per selection step: {ms * 1e3 / (npoint - 1):.4f}"
            " us")

        new_xyz, r, ns = lv["new_xyz"], lv["radius"], lv["nsample"]
        idx, cnt = torch.empty_like(lv["idx"]), torch.empty_like(lv["cnt"])
        ms = event_ms(torch, lambda: grouping.launch_ball_query(
            r, xyz, new_xyz, idx, cnt), 50, prefill=True)
        plain = event_ms(torch, lambda: grouping.ball_query_plain(
            r, ns, xyz, new_xyz), 5)
        add("ball_query", f"N={n} M={npoint} ns={ns} r={r}", ms, plain,
            ball_query_bound(xyz, new_xyz, lv["idx"], lv["cnt"], ns))
        log(f"  ball_query latency per query: {ms * 1e3 / (B * npoint):.6f}"
            " us")

        flat = lv["idx"].reshape(B, -1)
        for pts, ix in ((xyz, lv["fidx"]),
                        (lv["lifted"].to(torch.bfloat16), flat)):
            o = torch.empty((B, ix.shape[1], pts.shape[2]), dtype=pts.dtype,
                            device=dev)
            ix64 = ix.long()[..., None].expand(-1, -1, pts.shape[2])
            ms = event_ms(torch, lambda: grouping.launch_gather_rows(
                pts, ix, o), 100, prefill=True)
            plain = event_ms(torch, lambda: grouping.gather_rows_plain(
                pts, ix), 20)
            library = event_ms(torch, lambda: torch.gather(pts, 1, ix64), 100,
                               prefill=True)
            byts = (pts.numel() * pts.element_size() + ix.numel() * 4
                    + o.numel() * o.element_size())
            add("gather_rows", f"{tuple(pts.shape)} {str(pts.dtype)[6:]} by "
                f"{tuple(ix.shape)}", ms, plain, roofline(0, byts), library)
    Bs, n, npoint = FPS_SEG
    xyz = fps_seg_input(torch, dev)
    out = torch.empty((Bs, npoint), dtype=torch.int32, device=dev)
    ms = event_ms(torch, lambda: sampling.launch_fps(xyz, out), 10,
                  prefill=True)
    plain = event_ms(torch, lambda: sampling.fps_plain(xyz, npoint), 2)
    bound = fps_bound(Bs, n, npoint)
    log(f"  fps sem_seg SA1 ({Bs},{n},3)->{npoint}: kernel {ms:.6f} ms "
        f"({ms * 1e3 / (npoint - 1):.4f} us a selection step), plain "
        f"{plain:.6f} ms, bound {bound[0]:.6f} ms ({bound[1]}); logged, not "
        "in the table (a sem_seg forward's launch)")
    time_ball_query_seg(torch, dev, blocks)


def time_ball_query_seg(torch, dev, blocks: np.ndarray) -> float:
    """Phase 5: the ball query at sem_seg SA1's shape on the room's columns,
    logged (a sem_seg forward's launch, not in the table); returns the
    kernel's ms a launch. It drives whichever ``pointnet2_tpu_torch`` is
    imported, so it also times another checkout's kernel in the same
    process (``make_room``/``room_blocks`` as ``main`` makes them)."""
    from pointnet2_tpu_torch.ops import grouping

    Bq, n, npoint, r, ns = BQ_SEG
    xyz, new_xyz = ball_query_seg_input(torch, dev, blocks)
    want_idx, want_cnt = grouping.ball_query_plain(r, ns, xyz, new_xyz)
    idx, cnt = torch.empty_like(want_idx), torch.empty_like(want_cnt)
    ms = event_ms(torch, lambda: grouping.launch_ball_query(
        r, xyz, new_xyz, idx, cnt), 20, prefill=True)
    plain = event_ms(torch, lambda: grouping.ball_query_plain(
        r, ns, xyz, new_xyz), 2)
    bound = ball_query_bound(xyz, new_xyz, want_idx, want_cnt, ns)
    same = torch.equal(idx, want_idx) and torch.equal(cnt, want_cnt)
    log(f"  ball_query sem_seg SA1 ({Bq},{n},3)->{npoint} r={r} ns={ns} on "
        f"the room's columns: kernel {ms:.6f} ms "
        f"({ms * 1e3 / (Bq * npoint):.6f} us a query), plain {plain:.6f} ms, "
        f"bound {bound[0]:.6f} ms ({bound[1]}), bit-identical {same}; "
        "logged, not in the table (a sem_seg forward's launch)")
    return ms


def kernel_table(rows: dict, launches: dict, errs: dict) -> list:
    """The {"kernels": [...]} entries: launches from the main-path runs,
    every time measured in this run, the bound computed from its inputs."""
    return [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": errs[name], "ms": rows[name]["ms"],
        "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"],
        "bound_by": max(rows[name]["by"], key=rows[name]["by"].get),
        "library_ms": rows[name]["library_ms"],
    } for name in REPLACES]


def trace_device(torch, fn, reps: int) -> tuple:
    """torch.profiler over `reps` calls of `fn` after one warm-up step
    inside the profiler: (device kernels, host ops with the device time
    they launched, each as (us per call, calls per call, name); wall us
    per call under the profiler; the wrappers' launches in the window)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from pointnet2_tpu_torch import ops

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        before = {k: f.launches for k, f in ops.KERNELS.items()}
        t0 = time.perf_counter()
        for i in range(reps):
            fn()
            if i == reps - 1:
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6 / reps
            prof.step()
    launched = {k: f.launches - before[k] for k, f in ops.KERNELS.items()}
    kernels, ops_ = [], []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.key.startswith("ProfilerStep"):  # the schedule's step ranges
            continue
        if str(e.device_type).endswith("CUDA"):
            kernels.append((us / reps, e.count / reps, e.key))
        elif us > 0:  # a host op, charged with the kernels it launched
            ops_.append((us / reps, e.count / reps, e.key))
    return kernels, ops_, wall_us, launched


# rows 2 and 3 are two instances of one kernel template
TRACE_NAMES = {"ball_query": ("ball_query_kernel<false>",),
               "ball_query_group_xyz": ("ball_query_kernel<true>",)}


def traced(name: str, key: str) -> bool:
    """Whether a trace's kernel `key` is the one kernel a call of wrapper
    `name` launches: `<name>_kernel`, in bf16 on the tensor cores
    `<name>_mma_kernel`, or its template instance (TRACE_NAMES)."""
    names = TRACE_NAMES.get(name, (f"{name}_kernel", f"{name}_mma_kernel"))
    return any(n in key for n in names)


def profile_device(torch, fn, reps: int, label: str, unit: str,
                   ours=tuple(REPLACES), host_us: float | None = None) -> None:
    """Where the device time of `reps` calls of `fn` goes, by
    torch.profiler: device time by host op and by kernel per call, and the
    share of the wall time the device was busy under the profiler (whose
    own cost inflates the wall time) and, given `host_us`, of that
    unprofiled wall time of one call. One warm-up step runs inside the
    profiler before the recorded ones (without it the trace loses the
    first kernels of its window), and the trace's launches of the port's
    kernels are held against the wrappers' counters."""
    kernels, ops_, wall_us, launched = trace_device(torch, fn, reps)
    busy = sum(r[0] for r in kernels)
    if busy == 0:
        log(f"  profile {label}: the profiler saw no device time (not "
            "measured)")
        return
    log(f"  profile {label}: wall {wall_us:.1f} us/{unit} under the "
        f"profiler, device busy {busy:.1f} us ({busy / wall_us:.1%}), "
        f"{sum(r[1] for r in kernels):.0f} device ops/{unit}")
    if host_us is not None:
        log(f"   device busy {busy / host_us:.1%} of the unprofiled "
            f"{host_us:.1f} us/{unit} (idle {1 - busy / host_us:.1%})")
    seen = {k: round(sum(r[1] for r in kernels if traced(k, r[2])) * reps)
            for k in ours}
    missed = {k: (seen[k], launched[k]) for k in ours
              if seen[k] != launched[k]}
    log("   the trace saw every launch of the port's kernels" if not missed
        else "   the trace saw " + ", ".join(
            f"{k} {s} of {n}" for k, (s, n) in missed.items())
        + " launches: its device times are short by the missed ones")
    for title, rows in (("by host op", ops_), ("by kernel", kernels)):
        log(f"   device time {title} (us/{unit}, calls/{unit}):")
        for us, count, key in sorted(rows, reverse=True)[:12]:
            log(f"    {us:10.1f} us {count:6.1f}x  {key[:80]}")
    mine = [r for r in kernels
            if any(f"{k}_kernel" in r[2] for k in (*ours, *HELPERS))]
    log(f"   the port's CUDA kernels: {sum(r[0] for r in mine):.1f} us/{unit} "
        f"({sum(r[0] for r in mine) / busy:.1%} of device time)")
    for us, count, key in sorted(mine, reverse=True):
        log(f"    {us:10.1f} us {count:6.1f}x  {key[:80]}")


def profile_forward(torch, pred, clouds: np.ndarray, b: int,
                    reps: int = 5) -> None:
    """Phase 5c: where one bucketed bf16 forward's time goes."""
    profile_device(torch, lambda: pred(clouds[:b]), reps, f"bf16 B={b}",
                   "forward")


# --- the train path ---------------------------------------------------------


def bf16_ulp(torch, x):
    """One bf16 ulp at |x| (8 significant bits), the smallest normal's for
    0."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def scatter_same(torch, got, g, idx, n: int) -> tuple:
    """The scatter kernel's output against its plain version run on CPU
    copies of the same inputs (``index_add_`` adds each row's terms one
    after another in ascending k, as the kernel does): (bit for bit,
    max abs diff)."""
    from pointnet2_tpu_torch.ops import grouping

    want = grouping.scatter_rows_plain(g.cpu(), idx.cpu(), n)
    got = got.cpu()
    view = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
    diff = (got.float() - want.float()).abs()
    return (got.shape == want.shape and torch.equal(got.view(view),
                                                    want.view(view)),
            float(diff.max()) if diff.numel() else 0.0)


def check_scatter(torch, dev, check: Checks, errs: dict) -> None:
    """Phase 6: the scatter kernel bit for bit against its plain version on
    CPU copies of the same inputs, its CSR (offsets, perm) equal to the
    plain CSR of the same indices, two launches bitwise equal."""
    from pointnet2_tpu_torch import ops
    from pointnet2_tpu_torch.ops import grouping

    log("phase 6: the scatter-add kernel vs its plain version on CPU "
        "copies, bit for bit")
    B = 16
    levels = kernel_inputs(torch, dev, B)
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    sa1, sa2 = levels
    idx1, idx2 = sa1["idx"].reshape(B, -1), sa2["idx"].reshape(B, -1)
    oob = idx1.clone()
    oob[:, 3::11] = -1
    oob[:, 5::13] = sa1["n"]
    # sem_seg SA1 (predict_scene's blocks): 8192 points, 1024 balls of 32
    # at r=0.1, rows as wide as its first dense (32)
    xyz = torch.from_numpy(make_clouds(B, 8192, SEED + 6)).to(dev)
    sem_idx, _ = ops.ball_query_kernel(
        0.1, 32, xyz, ops.gather_rows_kernel(xyz, ops.fps_kernel(xyz, 1024)))
    cases = [  # (name, K-source idx, n, C)
        ("SA1 backward", idx1, sa1["n"], sa1["width"]),
        ("SA2 backward", idx2, sa2["n"], sa2["width"]),
        ("sem_seg SA1 backward", sem_idx.reshape(B, -1), 8192, 32),
        ("C=3 (xyz, FPS indices)", sa1["fidx"], sa1["n"], 3),
        ("C=5", idx1, sa1["n"], 5),
        ("hot row", torch.full_like(idx1, 7), sa1["n"], 64),
        ("out-of-range indices", oob, sa1["n"], 64),
        ("K=0", idx1[:, :0].contiguous(), sa1["n"], 64),
    ]
    for name, idx, n, C in cases:
        gf = torch.randn((B, idx.shape[1], C), generator=g, device=dev)
        woff, wperm = grouping.scatter_csr_plain(idx.cpu(), n)
        for dt in (torch.float32, torch.bfloat16):
            gd = gf.to(dt)
            before = ops.scatter_rows_kernel.launches
            got, off, perm = ops.scatter_rows_kernel(gd, idx, n,
                                                     return_csr=True)
            again = ops.scatter_rows_kernel(gd, idx, n)
            launched = ops.scatter_rows_kernel.launches - before
            view = torch.int16 if dt == torch.bfloat16 else torch.int32
            same = torch.equal(got.view(view), again.view(view))
            plain, err = scatter_same(torch, got, gd, idx, n)
            csr = torch.equal(off.cpu(), woff) and torch.equal(perm.cpu(),
                                                              wperm)
            errs["scatter_rows"] = max(errs["scatter_rows"], err)
            ok = plain and csr and same and launched == 2
            if name == "K=0":
                ok = ok and not bool(got.any())
            if name == "hot row":
                ok = ok and not bool(got[:, :7].any() or got[:, 8:].any())
            check(ok, f"scatter_rows {name} {str(dt)[6:]} g {tuple(gd.shape)} "
                      f"-> n={n}: bit for bit the plain version on CPU copies "
                      f"{plain} (max abs diff {err:.3e}), CSR equal to the "
                      f"plain CSR {csr}, two launches bitwise equal {same}, "
                      f"{launched} launches")
    torch.cuda.synchronize()


def make_trainer(torch, dtype: str, log_dir: str, epochs: int, seed=SEED,
                 model: str = "pointnet2_cls_ssg", num_point: int = N_POINT,
                 augment: str = "cls", batch_size: int = 16, device="cuda",
                 **config):
    from pointnet2_tpu_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(model=model, batch_size=batch_size,
                      num_point=num_point, max_epoch=epochs,
                      learning_rate=1e-3, optimizer="adam", augment=augment,
                      compute_dtype=dtype, log_dir=log_dir, seed=seed,
                      **config)
    return Trainer(cfg, device=device)


def train_batch(torch, dev, B: int = 16) -> dict:
    labels = np.arange(B) % NUM_CLASSES
    return {"points": torch.from_numpy(make_clouds(B, N_POINT, SEED + 7)).to(
        dev), "label": torch.from_numpy(labels).to(dev),
        "mask": torch.ones(B, device=dev)}


def one_step(torch, trainer, batch: dict, impl: str, gen_seed: int = 5,
             fused: bool = False):
    """A fresh state (the seed's weights), one step on `batch` with the
    generator at `gen_seed` and the fused-chain gate at `fused`; returns
    loss, grads, buffers and params."""
    from pointnet2_tpu_torch import config
    from pointnet2_tpu_torch.train.steps import run_one_step

    state = trainer.init_state()
    trainer.generator.manual_seed(gen_seed)
    with config.default_impl(impl), config.fused_mlp(fused):
        m = run_one_step(state, batch, trainer.loss_fn, trainer.bn_schedule,
                         trainer.augment_fn, trainer.generator, trainer.task)
    model = state.model
    return (float(m["loss"]),
            {k: p.grad.clone() for k, p in model.named_parameters()},
            {k: b.clone() for k, b in model.named_buffers()},
            {k: p.detach().clone() for k, p in model.named_parameters()})


def bn_fed_bias(name: str) -> bool:
    """A dense bias in front of a train-mode BN: its gradient is zero in
    exact arithmetic (BN subtracts the batch mean) and what is computed is
    the rounding residue of cancelling sums, not compared."""
    return name.endswith("dense.bias") and not name.startswith("fc3.")


def check_train_step(torch, dev, check: Checks, log_dir: str) -> None:
    """Phase 7: one full-width step (B=16, N=1024, augment on) through the
    kernels and through the plain versions. The forward is the same bits
    (identical indices, exact gathers), so loss and running statistics
    must be equal; gradients differ only by the scatter's summation order
    (atomic index_add_ in the plain path): each within 1e-4 (f32) or 1e-2
    (bf16) of its norm."""
    log("phase 7: one train step, kernel path vs plain path on the card")
    batch = train_batch(torch, dev)
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 1e-2)):
        with make_trainer(torch, dtype, os.path.join(log_dir, "step"),
                          1) as tr:
            la, ga, ba, pa = one_step(torch, tr, batch, "auto")
            lb, gb, bb, _ = one_step(torch, tr, batch, "torch")
            lc, gc, _, pc = one_step(torch, tr, batch, "auto")
        stats_equal = all(torch.equal(ba[k], bb[k]) for k in ba)
        worst, worst_k = 0.0, ""
        for k in ga:
            if bn_fed_bias(k):
                continue
            rel = float((ga[k] - gb[k]).float().norm()
                        / gb[k].float().norm().clamp_min(1e-30))
            if rel > worst:
                worst, worst_k = rel, k
        check(la == lb and stats_equal and worst <= tol,
              f"{dtype}: loss {la:.6f} (plain {lb:.6f}), running statistics "
              f"equal: {stats_equal}, largest gradient difference {worst:.2e} "
              f"of its norm ({worst_k}), bound {tol:g}")
        differ = [k for k in pa if not torch.equal(pa[k], pc[k])]
        gdiffer = [k for k in ga if not torch.equal(ga[k], gc[k])]
        if not differ and lc == la:
            log(f"  {dtype}: two runs of the kernel path give bitwise equal "
                "loss, gradients and parameters")
        else:
            log(f"  {dtype}: two runs of the kernel path differ: loss equal "
                f"{lc == la}, {len(gdiffer)} gradients and {len(differ)} "
                f"parameters differ; first differing gradient (backward "
                f"order, the op that produced it): "
                f"{gdiffer[-1] if gdiffer else 'none'}")
    torch.cuda.synchronize()


def train_fit(torch, check: Checks, log_dir: str) -> dict:
    """Phase 8: the train path's main-path run through Trainer.fit, bf16
    then f32, from the launch counters' zero; returns the counts, the
    trained bf16 state and the steps taken."""
    from pointnet2_tpu_torch import ops
    from pointnet2_tpu_torch.data import SyntheticClassification

    log(f"phase 8: Trainer.fit pointnet2_cls_ssg, N={N_POINT}, batch 16, "
        f"augment='cls', Adam lr 1e-3, {TRAIN_EPOCHS} epochs each in bf16 "
        "and f32")
    datasets = [SyntheticClassification(num_classes=NUM_CLASSES,
                                        samples_per_class=8, npoints=N_POINT,
                                        batch_size=16, seed=s)
                for s in (0, 1)]
    for w in ops.KERNELS.values():
        w.launches = 0
    states, steps, evals = {}, 0, 0
    for dtype in ("bfloat16", "float32"):
        run_dir = os.path.join(log_dir, f"fit_{dtype}")
        t0 = time.perf_counter()
        with make_trainer(torch, dtype, run_dir, TRAIN_EPOCHS) as tr:
            states[dtype] = tr.fit(datasets[0], eval_dataset=datasets[1])
            best = tr.best_score
        torch.cuda.synchronize()
        steps += states[dtype].step
        evals += TRAIN_EPOCHS * datasets[1].num_batches()
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses = [r["loss"] for r in rows if r["split"] == "train"]
        accs = [r["accuracy"] for r in rows if r["split"] == "eval"]
        check(len(losses) == TRAIN_EPOCHS and losses[-1] < losses[0]
              and all(np.isfinite(losses)),
              f"{dtype}: train loss by epoch {[round(x, 4) for x in losses]} "
              f"falls (eval accuracy {[round(x, 4) for x in accs]}, best "
              f"{best:.4f}); {time.perf_counter() - t0:.1f} s")
    counts = {k: w.launches for k, w in ops.KERNELS.items()}
    log(f"  launches in the train main-path run ({steps} steps, {evals} eval "
        f"forwards): {counts}")
    check(counts["scatter_rows"] == 2 * steps,
          "scatter_rows launched 2 times per train step")
    for name, per_fwd in (("fps", 2), ("ball_query", 2), ("gather_rows", 4)):
        check(counts[name] == per_fwd * (steps + evals),
              f"{name} launched {per_fwd} times per forward, as in serving")
    return {"counts": counts, "state": states["bfloat16"], "steps": steps}


def serve_trained(torch, state, clouds: np.ndarray, check: Checks) -> None:
    from pointnet2_tpu_torch import Predictor

    pred = Predictor("pointnet2_cls_ssg", state.model.state_dict(),
                     dtype=torch.bfloat16)
    votes = pred.predict_votes(clouds[:16], 12, rng=SEED)
    check(votes.shape == (16, NUM_CLASSES) and bool(np.isfinite(votes).all()),
          "the trained bf16 weights serve through Predictor.predict_votes: "
          f"(16, 40), finite, argmax {votes.argmax(-1)[:8].tolist()}...")


def time_train(torch, dev, gpu: str, log_dir: str) -> None:
    """Phase 9: train-step times at B=16."""
    from pointnet2_tpu_torch.train.steps import run_one_step

    log(f"phase 9: train-step times at B=16, N={N_POINT}, on {gpu}")
    batch = train_batch(torch, dev)
    for dtype in ("bfloat16", "float32"):
        with make_trainer(torch, dtype, os.path.join(log_dir, "time"),
                          1) as tr:
            state = tr.init_state()

            def step():
                run_one_step(state, batch, tr.loss_fn, tr.bn_schedule,
                             tr.augment_fn, tr.generator)

            ms = host_ms(torch, step, 20, warmup=3)
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"  train step {dtype}: {ms:.3f} ms median of 20, "
                f"{16 / ms * 1e3:.1f} examples/s, peak device memory "
                f"{peak:.2f} GiB")
            profile_device(torch, step, 5, f"train step {dtype} B=16",
                           "step")


def time_scatter(torch, dev, gpu: str, rows: dict) -> None:
    """Phase 9b: the scatter kernel per launch at the train step's shapes,
    beside its bound, its plain version and ``Tensor.index_add_``."""
    from pointnet2_tpu_torch.ops import grouping

    log(f"phase 9: scatter_rows per launch at B=16 on {gpu} (kernel and "
        "index_add_ with the queue pre-filled, plain with the host in the "
        "loop)")
    B = 16
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    for lv in kernel_inputs(torch, dev, B):
        idx = lv["idx"].reshape(B, -1)
        n, C, K = lv["n"], lv["width"], idx.shape[1]
        flat = (idx.long() + torch.arange(B, device=dev)[:, None] * n
                ).reshape(-1)
        for dt in (torch.bfloat16, torch.float32):
            gd = torch.randn((B, K, C), generator=g, device=dev).to(dt)
            out = torch.empty((B, n, C), dtype=dt, device=dev)
            lib_out = torch.zeros((B * n, C), dtype=dt, device=dev)
            g2 = gd.reshape(B * K, C)
            bufs = grouping.scatter_buffers(idx, n)
            ms = event_ms(torch, lambda: grouping.launch_scatter_rows(
                gd, idx, out, bufs), 50, prefill=True)
            plain = event_ms(torch, lambda: grouping.scatter_rows_plain(
                gd, idx, n), 20)
            library = event_ms(torch, lambda: lib_out.index_add_(0, flat, g2),
                               50, prefill=True)
            byts = (gd.numel() * gd.element_size() + idx.numel() * 4
                    + out.numel() * out.element_size())
            bound = roofline(0, byts)
            shape = f"g {tuple(gd.shape)} {str(dt)[6:]} -> n={n}"
            if dt == torch.bfloat16:  # the table holds the bf16 train step
                add_time(rows, "scatter_rows", shape, ms, plain, bound,
                         library)
            else:
                log(f"  scatter_rows {shape:<44} kernel {ms:.6f} ms  plain "
                    f"{plain:.6f} ms  bound {bound[0]:.6f} ms library "
                    f"{library:.6f} ms")
            log(f"  scatter_rows {shape}: {bound[0] / ms:.1%} of the memory "
                "roofline")


# --- the segmentation serving path -------------------------------------------

SEM, PART = "pointnet2_sem_seg", "pointnet2_part_seg"
SEM_N, PART_N = 8192, 2048  # points per ScanNet block / ShapeNet-part cloud
# launches per forward of each model's main path
SEG_PER_FWD = {SEM: {"fps": 4, "ball_query": 4, "gather_rows": 12,
                     "scatter_rows": 0, "three_nn": 4},
               PART: {"fps": 2, "ball_query": 2, "gather_rows": 7,
                      "scatter_rows": 0, "three_nn": 3}}


def make_room(n_points: int, seed: int, size=(6.0, 5.0, 2.7)) -> np.ndarray:
    """A generated room of about n_points surface samples, z up, metres:
    floor, ceiling, four walls and 8 boxes of furniture standing on the
    floor, sampled uniformly by area."""
    rng = np.random.default_rng(seed)
    W, D, H = size
    boxes = []
    for _ in range(8):
        w, d = rng.uniform(0.4, 1.6, 2)
        h = rng.uniform(0.4, 1.9)
        x, y = rng.uniform(0.1, W - w - 0.1), rng.uniform(0.1, D - d - 0.1)
        boxes.append((x, y, w, d, h))
    # (origin, edge u, edge v) of every rectangle
    rects = [((0, 0, 0), (W, 0, 0), (0, D, 0)),  # floor
             ((0, 0, H), (W, 0, 0), (0, D, 0)),  # ceiling
             ((0, 0, 0), (W, 0, 0), (0, 0, H)),
             ((0, D, 0), (W, 0, 0), (0, 0, H)),
             ((0, 0, 0), (0, D, 0), (0, 0, H)),
             ((W, 0, 0), (0, D, 0), (0, 0, H))]
    for x, y, w, d, h in boxes:
        rects += [((x, y, h), (w, 0, 0), (0, d, 0)),
                  ((x, y, 0), (w, 0, 0), (0, 0, h)),
                  ((x, y + d, 0), (w, 0, 0), (0, 0, h)),
                  ((x, y, 0), (0, d, 0), (0, 0, h)),
                  ((x + w, y, 0), (0, d, 0), (0, 0, h))]
    o, u, v = (np.array([r[k] for r in rects], np.float64) for k in range(3))
    area = np.linalg.norm(np.cross(u, v), axis=1)
    which = rng.choice(len(rects), n_points, p=area / area.sum())
    a, b = rng.uniform(0, 1, (2, n_points, 1))
    pts = o[which] + a * u[which] + b * v[which]
    pts += rng.normal(0, 0.005, pts.shape)  # scanner noise
    return pts.astype(np.float32)


def room_blocks(room: np.ndarray, n_blocks: int, seed: int) -> np.ndarray:
    """(n_blocks, 8192, 3) training-style ScanNet blocks: the points of a
    random 1.5 m column of the room, sampled to 8192 (with replacement
    where the column holds fewer), in room coordinates."""
    rng = np.random.default_rng(seed)
    lo, hi = room.min(0), room.max(0)
    out = np.empty((n_blocks, SEM_N, 3), np.float32)
    for i in range(n_blocks):
        c = rng.uniform(lo[:2] + 0.75, hi[:2] - 0.75)
        inside = np.flatnonzero((np.abs(room[:, :2] - c) <= 0.75).all(1))
        pick = rng.choice(inside, SEM_N, replace=len(inside) < SEM_N)
        out[i] = room[pick]
    return out


def fp_shapes(torch, dev, blocks: np.ndarray, parts: np.ndarray) -> list:
    """The (unknown, known) clouds of every FP of the two models on these
    inputs, from the FPS chain through the kernels: sem_seg fp1-fp4, then
    part_seg fp1 (the group_all centre, M=1), fp2, fp3."""
    from pointnet2_tpu_torch import ops

    out = []
    for name, pc, npoints in ((SEM, blocks, (1024, 256, 64, 16)),
                              (PART, parts, (512, 128))):
        levels = [torch.from_numpy(np.ascontiguousarray(pc[..., :3])).to(dev)]
        for npt in npoints:
            levels.append(ops.gather_rows_kernel(
                levels[-1], ops.fps_kernel(levels[-1], npt)))
        if name == PART:  # the group_all centre
            levels.append(torch.zeros_like(levels[-1][:, :1]))
        for k in range(len(levels) - 1, 0, -1):
            out.append((f"{name[10:]} fp{len(levels) - k}", levels[k - 1],
                        levels[k]))
    return out


def check_three_nn(torch, shapes: list, check: Checks, errs: dict) -> None:
    """Phase 10: the three_nn kernel against its plain version at every FP
    shape, bit for bit, and two launches give the same bits."""
    from pointnet2_tpu_torch.ops import interpolate

    log("phase 10: three_nn kernel vs plain version on the card, every FP "
        "shape at B=16")
    for tag, xyz1, xyz2 in shapes:
        d, i = interpolate.three_nn_kernel(xyz1, xyz2)
        d2, i2 = interpolate.three_nn_kernel(xyz1, xyz2)
        wd, wi = interpolate.three_nn_plain(xyz1, xyz2)
        same = (torch.equal(i, wi) and torch.equal(d.view(torch.int32),
                                                   wd.view(torch.int32)))
        again = torch.equal(i, i2) and torch.equal(d.view(torch.int32),
                                                   d2.view(torch.int32))
        errs["three_nn"] = max(errs["three_nn"],
                               int((i - wi).abs().max()),
                               float((d - wd).nan_to_num(0.0).abs().max()))
        zero = float((d[..., 0] == 0).float().mean())
        check(same and again, f"three_nn {tag} N={xyz1.shape[1]} "
              f"M={xyz2.shape[1]}: bit-identical to plain, two launches "
              f"equal ({zero:.1%} of nearest distances exactly 0)")
    # ties: a known set repeated at a stride of 13 (260 points, the walk
    # with bits) and of 7 (63 points, the direct walk), each unknown
    # point's three nearest the copies j, j + s, j + 2s of one point, at
    # one (1536 unknown points) and two (65536) unknown points a thread;
    # with s = 13 some copies fall in different batches of 32 known points
    dev = shapes[0][1].device
    rng = np.random.default_rng(SEED + 10)
    for stride, copies in ((13, 20), (7, 9)):
        known = torch.from_numpy(rng.random((16, stride, 3), np.float32)).to(
            dev).repeat(1, copies, 1).contiguous()
        for n in (96, 4096):
            xyz1 = torch.from_numpy(rng.random((16, n, 3), np.float32)).to(
                dev)
            d, i = interpolate.three_nn_kernel(xyz1, known)
            wd, wi = interpolate.three_nn_plain(xyz1, known)
            same = torch.equal(i, wi) and torch.equal(
                d.view(torch.int32), wd.view(torch.int32))
            tied = bool(torch.equal(wd[..., 0], wd[..., 2]) and torch.equal(
                wi[..., 2] - wi[..., 0],
                torch.full_like(wi[..., 0], 2 * stride)))
            cross = int((wi[..., 0] // 32 != wi[..., 2] // 32).sum())
            check(same and tied and (stride == 7 or cross > 0),
                  f"three_nn ties (16, {n}, 3) x (16, {stride * copies}, 3):"
                  f" bit-identical to plain, every unknown point's three "
                  f"nearest at equal distances {stride} apart ({cross} "
                  f"across two batches of 32)")
    torch.cuda.synchronize()


def drive_seg(torch, preds: dict, blocks, parts, room) -> dict:
    """Phase 11's main-path runs, one per model, each from the launch
    counters' zero: sem_seg requests of 1, 16, 64 and 100 blocks and
    predict_scene on the room (bf16) and part_seg requests of 16 and 64
    clouds, each in bf16 and f32. Returns outputs, launches and forward
    calls by model."""
    from pointnet2_tpu_torch import ops

    out = {"launches": {}, "forwards": {}}
    for name, reqs, data in ((SEM, (1, 16, 64, 100), blocks),
                             (PART, (16, 64), parts)):
        for w in ops.KERNELS.values():
            w.launches = 0
        before = {dt: preds[(name, dt)].calls[0] for dt in ("bf16", "f32")}
        for dt in ("bf16", "f32"):
            for b in reqs:
                out[(name, dt, b)] = preds[(name, dt)].pred(data[:b])
        if name == SEM:
            out["scene"] = preds[(SEM, "bf16")].pred.predict_scene(
                room, seed=SEED)
        torch.cuda.synchronize()
        out["launches"][name] = {k: w.launches for k, w in ops.KERNELS.items()}
        out["forwards"][name] = sum(preds[(name, dt)].calls[0] - before[dt]
                                    for dt in ("bf16", "f32"))
    return out


class Served:
    """A Predictor and the count of its model's forward calls."""

    def __init__(self, name, sd, dtype):
        from pointnet2_tpu_torch import Predictor

        self.pred = Predictor(name, sd, dtype=dtype)
        self.calls = [0]  # incremented by a forward hook on the model
        self.pred.model.register_forward_hook(
            lambda *_: self.calls.__setitem__(0, self.calls[0] + 1))


def close(got, want, rel: float) -> tuple:
    """(max abs diff, range of want, whether within rel of the range)."""
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    return err, scale, err <= rel * scale


def check_seg(torch, preds, run, blocks, parts, room, sds,
              check: Checks) -> None:
    """Phase 11's checks on the main-path run."""
    from pointnet2_tpu_torch import Predictor, config

    for name, per in SEG_PER_FWD.items():
        n = run["forwards"][name]
        got = run["launches"][name]
        log(f"  {name}: launches in its main-path run ({n} forwards): {got}")
        for k, per_fwd in per.items():
            check(got[k] == per_fwd * n,
                  f"{name}: {k} launched {per_fwd} times per forward")
    K = {SEM: 21, PART: 50}
    for key, lg in run.items():
        if isinstance(key, tuple):
            name, _, b = key
            n_pts = SEM_N if name == SEM else PART_N
            check(lg.shape == (b, n_pts, K[name])
                  and bool(np.isfinite(lg).all()),
                  f"{key}: shape {lg.shape}, finite")
    # kernel path vs the same requests on the plain versions at B <= 16:
    # identical indices and exact gathers, so expected difference 0; bound
    # 1e-5 of the range for a cuBLAS algorithm choice that might differ
    with config.default_impl("torch"):
        for (name, dt), sv in preds.items():
            data = blocks if name == SEM else parts
            for b in ((1, 16) if name == SEM else (16,)):
                want = sv.pred(data[:b])
                got = run[(name, dt, b)]
                err, scale, ok = close(got, want, 1e-5)
                agree = bool((got.argmax(-1) == want.argmax(-1)).all())
                check(ok and agree, f"{name} {dt} B={b}: kernel vs plain max "
                      f"abs diff {err:.3e} (logit range {scale:.3f}), argmax "
                      "agrees")
    # f32 on the card vs the CPU's plain path, 2 inputs: geometry bit for
    # bit, matmul order differs; bound 1e-4 of the range as the CPU tests
    for name, data in ((SEM, blocks), (PART, parts)):
        cpu = Predictor(name, sds[name], dtype=torch.float32, device="cpu")
        err, scale, ok = close(run[(name, "f32", 16)][:2], cpu(data[:2]), 1e-4)
        check(ok, f"{name} f32 on the card vs the CPU, 2 inputs: max abs "
              f"diff {err:.3e} (range {scale:.3f})")
        err, scale, ok = close(run[(name, "bf16", 64)],
                               run[(name, "f32", 64)], 0.05)
        check(ok, f"{name} bf16 vs f32, 64 inputs: max abs diff {err:.3e} "
              f"(range {scale:.3f})")

    scene = run["scene"]
    n = len(room)
    log(f"  predict_scene on a room of {n} points: votes per point "
        f"{int(scene['votes'].min())}-{int(scene['votes'].max())}, mean "
        f"{scene['votes'].mean():.2f}")
    again = preds[(SEM, "bf16")].pred.predict_scene(room, seed=SEED)
    check(scene["logits"].shape == (n, 21) and scene["labels"].shape == (n,)
          and int(scene["votes"].min()) >= 1
          and all(np.array_equal(scene[k], again[k]) for k in scene),
          "predict_scene bf16: every point votes >= 1, finite "
          f"{bool(np.isfinite(scene['logits']).all())}, the same for the "
          "same seed")
    # f32, kernel path vs plain path, buckets up to 16 so the plain
    # versions run at B <= 16
    f32 = Predictor(SEM, sds[SEM], dtype=torch.float32, buckets=(1, 4, 16))
    a = f32.predict_scene(room, seed=SEED)
    with config.default_impl("torch"):
        b = f32.predict_scene(room, seed=SEED)
    err, scale, ok = close(a["logits"], b["logits"], 1e-5)
    top2 = np.sort(b["logits"], -1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2e-5 * scale
    check(np.array_equal(a["votes"], b["votes"]) and ok
          and np.array_equal(a["labels"][sure], b["labels"][sure]),
          f"predict_scene f32 kernel vs plain: votes equal, summed logits "
          f"max abs diff {err:.3e} (range {scale:.3f}), labels equal on "
          f"the {sure.mean():.1%} of points whose top-2 margin exceeds 2e-5 "
          "of the range")
    torch.cuda.synchronize()


def three_nn_entries(torch, xyz1, xyz2, k: int = 32) -> int:
    """The (unknown, known) pairs whose distance the ascending scan with a
    strict < inserts into the three best so far, from plain PyTorch ops
    on the card, k known points at a time."""
    B, N, M = xyz1.shape[0], xyz1.shape[1], xyz2.shape[1]
    best = torch.full((B, N, 3), float("inf"), device=xyz1.device)
    pos = torch.arange(3 + k, device=xyz1.device)
    total = 0
    for c0 in range(0, M, k):
        p = xyz2[:, c0:c0 + k]
        n = p.shape[1]
        dx, dy, dz = (xyz1[:, :, None, c] - p[:, None, :, c] for c in range(3))
        d = (dx * dx + dy * dy) + dz * dz  # (B, N, n), op by op
        seen = torch.cat([best, d], -1)
        # column u sees the three best before this slab and its u first
        before = pos[:3 + n] < 3 + torch.arange(n, device=xyz1.device)[:, None]
        third = torch.where(before, seen[:, :, None, :], float("inf")).topk(
            3, -1, largest=False).values[..., 2]
        total += int((d < third).sum())
        best = seen.topk(3, -1, largest=False).values
    return total


def launch_three_nn_q(torch, xyz1, xyz2, dist, idx, q: int) -> None:
    """csrc/three_nn.cu's launch with q unknown points a thread, whichever
    the shape takes, to measure the launch's own choice."""
    import ctypes

    from pointnet2_tpu_torch.ops import _build

    B, N, M = xyz1.shape[0], xyz1.shape[1], xyz2.shape[1]
    fn = _build.bind("three_nn", "pn2_three_nn_q",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p])
    _build.check("three_nn", fn(
        xyz1.data_ptr(), xyz2.data_ptr(), dist.data_ptr(), idx.data_ptr(), B,
        N, M, q, torch.cuda.current_stream().cuda_stream), "three_nn launch")


def time_seg(torch, gpu: str, preds, shapes, blocks, parts, room,
             rows: dict) -> None:
    """Phase 12: three_nn per launch at every FP shape beside its bound,
    its plain version and cdist + topk; three_interpolate at sem_seg fp4;
    seg forwards, predict_scene, peak memory, and where a bf16 B=16
    forward's device time goes."""
    from pointnet2_tpu_torch import ops
    from pointnet2_tpu_torch.ops import interpolate

    log(f"phase 12: three_nn per launch at B=16 on {gpu} (kernel and "
        "cdist+topk with the queue pre-filled, plain with the host in the "
        "loop; cdist+topk computes Euclidean, not squared, distances and is "
        "a yardstick only)")
    for tag, xyz1, xyz2 in shapes:
        B, N, M = xyz1.shape[0], xyz1.shape[1], xyz2.shape[1]
        dist = torch.empty((B, N, 3), device=xyz1.device)
        idx = torch.empty((B, N, 3), dtype=torch.int32, device=xyz1.device)
        ms = event_ms(torch, lambda: interpolate.launch_three_nn(
            xyz1, xyz2, dist, idx), 50, prefill=True)
        plain = event_ms(torch, lambda: interpolate.three_nn_plain(xyz1, xyz2),
                         5)
        k = min(3, M)
        library = event_ms(torch, lambda: torch.topk(
            torch.cdist(xyz1, xyz2), k, largest=False), 50, prefill=True)
        # a pair's bit: 3 FMAs and a compare; each point the ascending
        # scan inserts: sq_dist's 3 sub, 3 mul, 2 add and a compare
        entries = three_nn_entries(torch, xyz1, xyz2)
        ops_ = B * N * M * 4 + entries * 9
        byts = (xyz1.numel() + xyz2.numel()) * 4 + B * N * 3 * 8
        bound = roofline(ops_, byts)
        shape = f"{tag} ({B},{N},3) x ({B},{M},3)"
        if tag.startswith("sem"):  # the table holds the sem_seg forward
            add_time(rows, "three_nn", shape, ms, plain, bound, library)
        else:
            log(f"  {'three_nn':<12} {shape:<44} kernel {ms:.6f} ms  plain "
                f"{plain:.6f} ms  bound {bound[0]:.6f} ms library "
                f"{library:.6f} ms")
        log(f"  three_nn {tag}: {bound[0] / ms:.1%} of the {bound[1]} "
            f"roofline ({entries / (B * N):.1f} inserts an unknown point)")
        if B * N >= 65536:  # the launch takes two unknown points a thread
            one = event_ms(torch, lambda: launch_three_nn_q(
                torch, xyz1, xyz2, dist, idx, 1), 50, prefill=True)
            log(f"  three_nn {tag}: one unknown point a thread {one:.6f} ms "
                f"against two {ms:.6f} ms")

    # three_interpolate at sem_seg fp4 (B=16, bf16, the 128-wide lifted
    # rows): one gather of the (B, 3N, C) rows, then the f32 combine
    _, xyz1, xyz2 = shapes[3]
    d, i = ops.three_nn(xyz1, xyz2)
    w = 1.0 / d.clamp_min(1e-10)
    w = w / w.sum(-1, keepdim=True)
    g = torch.Generator(device=xyz1.device).manual_seed(SEED + 12)
    rows_ = torch.randn((16, xyz2.shape[1], 128), generator=g,
                        device=xyz1.device).bfloat16()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = event_ms(torch, lambda: ops.three_interpolate(rows_, i, w), 20)
    extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    inter = 16 * 3 * xyz1.shape[1] * 128 * 2 / 2 ** 20
    log(f"  three_interpolate sem fp4 (16,{xyz1.shape[1]},3) from "
        f"(16,{xyz2.shape[1]},128) bf16: {ms:.6f} ms a call, its gathered "
        f"(B,3N,C) rows {inter:.1f} MiB, peak extra device memory "
        f"{extra:.1f} MiB")

    log(f"phase 12: segmentation serving times (host clock, numpy in and "
        f"out) on {gpu}")
    host = {}
    for (name, dt), sv in preds.items():
        data = blocks if name == SEM else parts
        for b in (16, 64):
            ms = host[name, dt, b] = host_ms(torch,
                                             lambda: sv.pred(data[:b]), 10)
            torch.cuda.reset_peak_memory_stats()
            sv.pred(data[:b])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"  {name} {dt} B={b}: {ms:.3f} ms, {b / ms * 1e3:.1f} "
                f"inputs/s, peak device memory {peak:.2f} GiB")
    pred = preds[(SEM, "bf16")].pred
    torch.cuda.reset_peak_memory_stats()
    ms = host_ms(torch, lambda: pred.predict_scene(room, seed=SEED), 3,
                 warmup=1)
    log(f"  predict_scene bf16, room of {len(room)} points: {ms:.3f} ms, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    log(f"phase 12: where a bf16 B=16 forward's device time goes "
        f"(torch.profiler) on {gpu}")
    for name, data in ((SEM, blocks), (PART, parts)):
        sv = preds[(name, "bf16")]
        profile_device(torch, lambda: sv.pred(data[:16]), 3,
                       f"{name} bf16 B=16", "forward",
                       host_us=host[name, "bf16", 16] * 1e3)


# --- the multi-scale-grouping path -------------------------------------------

CLS_MSG = "pointnet2_cls_msg"
PART_MSG = "pointnet2_part_seg_msg_one_hot"
BASIC = "pointnet_cls_basic"
# every MSG layer of the two models: (model, layer, feature channels,
# npoint, radii, nsamples, mlps); N is the layer's input size
MSG_LAYERS = (
    (CLS_MSG, "sa1", 0, 512, (0.1, 0.2, 0.4), (16, 32, 128),
     ((32, 32, 64), (64, 64, 128), (64, 96, 128))),
    (CLS_MSG, "sa2", 320, 128, (0.2, 0.4, 0.8), (32, 64, 128),
     ((64, 64, 128), (128, 128, 256), (128, 128, 256))),
    (PART_MSG, "sa1", 3, 512, (0.1, 0.2, 0.4), (32, 64, 128),
     ((32, 32, 64), (64, 64, 128), (64, 96, 128))),
    (PART_MSG, "sa2", 320, 128, (0.4, 0.8), (64, 128),
     ((128, 128, 256), (128, 196, 256))),
)
# launches per forward of each model's main path (the default MSG layout:
# one ball query per radius, the lifted first dense gathered per radius)
_NONE = {k: 0 for k in REPLACES}
MSG_PER_FWD = {
    CLS_MSG: {**_NONE, "fps": 2, "ball_query": 6, "gather_rows": 8},
    PART_MSG: {**_NONE, "fps": 2, "ball_query": 5, "gather_rows": 10,
               "three_nn": 3},
    BASIC: _NONE,
}
# phase 14's requests per model (each in bf16 and f32), and phase 15's
# timed batch sizes
MSG_REQS = {CLS_MSG: (1, 16, 64, 100), PART_MSG: (16, 64), BASIC: (16,)}
MSG_TIMED = (16, 64)


def msg_levels(torch, dev, clouds: np.ndarray, parts: np.ndarray) -> list:
    """The ball-query inputs of every MSG layer on these clouds, from the
    FPS chain through the kernels: dicts with the layer's (model, name,
    radii, nsamples), xyz (B, N, 3) and new_xyz (B, npoint, 3)."""
    from pointnet2_tpu_torch import ops

    out = []
    for pc, model in ((clouds, CLS_MSG), (parts, PART_MSG)):
        xyz = torch.from_numpy(np.ascontiguousarray(pc[..., :3])).to(dev)
        for m, layer, _, npoint, radii, nss, _ in MSG_LAYERS:
            if m != model:
                continue
            new_xyz = ops.gather_rows_kernel(xyz, ops.fps_kernel(xyz, npoint))
            out.append({"model": model, "layer": layer, "radii": radii,
                        "nsamples": nss, "xyz": xyz, "new_xyz": new_xyz,
                        "tag": f"{model[10:]} {layer} N={xyz.shape[1]} "
                               f"M={npoint}"})
            xyz = new_xyz
    return out


def check_msg_kernels(torch, dev, levels: list, check: Checks,
                      errs: dict) -> None:
    """Phase 13: the ball query with grouped xyz and the multi-radius ball
    query against their plain versions at every MSG ball-query shape, and
    the grouped-xyz backward through the scatter kernel."""
    from pointnet2_tpu_torch import ops
    from pointnet2_tpu_torch.ops import grouping

    log("phase 13: ball_query_group_xyz and ball_query_multi vs plain "
        "versions on the card, every MSG shape at B=16")
    for lv in levels:
        xyz, new_xyz = lv["xyz"], lv["new_xyz"]
        rows = torch.arange(xyz.shape[0], device=dev)[:, None, None]
        for r, ns in zip(lv["radii"], lv["nsamples"]):
            idx, cnt, grp = ops.ball_query_group_xyz_kernel(r, ns, xyz,
                                                            new_xyz)
            widx, wcnt, wgrp = grouping.ball_query_group_xyz_plain(
                r, ns, xyz, new_xyz)
            same = (torch.equal(idx, widx) and torch.equal(cnt, wcnt)
                    and torch.equal(grp, wgrp)
                    and torch.equal(grp, xyz[rows, idx.long()]))
            errs["ball_query_group_xyz"] = max(
                errs["ball_query_group_xyz"], int((idx - widx).abs().max()),
                int((cnt - wcnt).abs().max()),
                float((grp - wgrp).abs().max()))
            check(same, f"ball_query_group_xyz {lv['tag']} r={r} ns={ns}: "
                  "idx, cnt bit-identical, grouped equal by value to plain "
                  f"and to xyz1[idx] (mean cnt {cnt.float().mean():.2f})")
        multi = ops.ball_query_multi_kernel(lv["radii"], lv["nsamples"], xyz,
                                            new_xyz)
        for (idx, cnt), r, ns in zip(multi, lv["radii"], lv["nsamples"]):
            sidx, scnt = ops.ball_query_kernel(r, ns, xyz, new_xyz)
            widx, wcnt = grouping.ball_query_plain(r, ns, xyz, new_xyz)
            errs["ball_query_multi"] = max(
                errs["ball_query_multi"], int((idx - widx).abs().max()),
                int((cnt - wcnt).abs().max()))
            check(torch.equal(idx, sidx) and torch.equal(cnt, scnt)
                  and torch.equal(idx, widx) and torch.equal(cnt, wcnt),
                  f"ball_query_multi {lv['tag']} radii {lv['radii']}: r={r} "
                  f"ns={ns} bit-identical to ball_query and to plain")

    # the backward: scatter-add of grouped's cotangent into the N rows, one
    # launch, bit for bit the plain scatter on CPU copies (phase 6)
    lv = levels[0]
    r, ns = lv["radii"][-1], lv["nsamples"][-1]
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    B, M = lv["new_xyz"].shape[:2]
    ct = torch.randn((B, M, ns, 3), generator=g, device=dev)
    x = lv["xyz"].clone().requires_grad_()
    before = ops.scatter_rows_kernel.launches
    idx, _, grp = ops.query_ball_and_group_xyz(r, ns, x, lv["new_xyz"])
    grp.backward(ct)
    launched = ops.scatter_rows_kernel.launches - before
    same, err = scatter_same(torch, x.grad, ct.reshape(B, -1, 3),
                             idx.reshape(B, -1), x.shape[1])
    errs["scatter_rows"] = max(errs["scatter_rows"], err)
    check(launched == 1 and same,
          f"ball_query_group_xyz backward {lv['tag']} r={r} ns={ns}: "
          f"{launched} scatter_rows launch, bit for bit the plain scatter on "
          f"CPU copies (max abs diff {err:.3e})")
    torch.cuda.synchronize()


def unfused_msg(torch, model, dt: str) -> dict:
    """cls_msg's two MSG layers rebuilt with fuse_first=False, holding the
    model's own sa1/sa2 weights."""
    from pointnet2_tpu_torch.nn import SetAbstractionMSG

    dtype = torch.bfloat16 if dt == "bf16" else None
    out = {}
    for m, layer, feat, npoint, radii, nss, mlps in MSG_LAYERS:
        if m != CLS_MSG:
            continue
        fused = getattr(model, layer)
        un = SetAbstractionMSG(npoint, radii, nss, feat, mlps, dtype=dtype,
                               fuse_first=False)
        un.load_state_dict(fused.state_dict(), strict=True)
        out[layer] = (fused, un.to(next(fused.parameters()).device).eval())
    return out


def drive_msg(torch, dev, preds: dict, clouds, parts, labels) -> dict:
    """Phase 14's main-path runs, each from the launch counters' zero:
    cls_msg requests of 1, 16, 64 and 100 clouds and a 12-vote request of
    16, part_seg_msg requests of 16 and 64 clouds with their labels, and
    cls_basic requests of 16, each in bf16 and f32; then the MSG layers'
    other routes at full width: cls_msg's sa1 and sa2 with fuse_first=False
    (bf16 and f32, on the served clouds) and the multi-radius ball query at
    every MSG layer's radius set."""
    from pointnet2_tpu_torch import ops

    out = {"launches": {}, "forwards": {}}
    for name, sizes in MSG_REQS.items():
        for w in ops.KERNELS.values():
            w.launches = 0
        before = {dt: preds[(name, dt)].calls[0] for dt in ("bf16", "f32")}
        for dt in ("bf16", "f32"):
            pred = preds[(name, dt)].pred
            for b in sizes:
                out[(name, dt, b)] = (pred(parts[:b], labels[:b])
                                      if name == PART_MSG
                                      else pred(clouds[:b]))
        if name == CLS_MSG:
            out["votes"] = preds[(name, "bf16")].pred.predict_votes(
                clouds[:16], 12, rng=SEED)
        torch.cuda.synchronize()
        out["launches"][name] = {k: w.launches for k, w in ops.KERNELS.items()}
        out["forwards"][name] = sum(preds[(name, dt)].calls[0] - before[dt]
                                    for dt in ("bf16", "f32"))

    # the fused layers' outputs (the reference) and the multi-radius
    # query's inputs first, outside the counted run
    xyz = torch.from_numpy(clouds[:16]).to(dev)
    layers = {dt: unfused_msg(torch, preds[(CLS_MSG, dt)].pred.model, dt)
              for dt in ("bf16", "f32")}
    with torch.inference_mode():
        ref = {}
        for dt, lay in layers.items():
            ref[dt] = lay["sa1"][0](xyz, None)
            ref[(dt, "sa2")] = lay["sa2"][0](*ref[dt])[1]
        levels = msg_levels(torch, dev, clouds[:16], parts[:16])
        torch.cuda.synchronize()
        for w in ops.KERNELS.values():
            w.launches = 0
        for dt, lay in layers.items():
            out[("sa1", dt)] = (ref[dt][1], lay["sa1"][1](xyz, None)[1])
            out[("sa2", dt)] = (ref[(dt, "sa2")], lay["sa2"][1](*ref[dt])[1])
        out["multi"] = [(lv, ops.query_ball_point_multi(
            lv["radii"], lv["nsamples"], lv["xyz"], lv["new_xyz"]))
            for lv in levels]
        torch.cuda.synchronize()
    out["launches"]["layers"] = {k: w.launches for k, w in ops.KERNELS.items()}
    return out


def check_msg(torch, preds, run, clouds, parts, labels, sds,
              check: Checks) -> None:
    """Phase 14's checks on the main-path runs."""
    from pointnet2_tpu_torch import Predictor, config
    from pointnet2_tpu_torch.ops import grouping

    for name, per in MSG_PER_FWD.items():
        n = run["forwards"][name]
        got = run["launches"][name]
        log(f"  {name}: launches in its main-path run ({n} forwards): {got}")
        for k, per_fwd in per.items():
            check(got[k] == per_fwd * n,
                  f"{name}: {k} launched {per_fwd} times per forward")
    got = run["launches"]["layers"]
    log(f"  the unfused cls_msg layers (bf16, f32) and the multi-radius "
        f"query at 4 radius sets: launches {got}")
    # per dtype: sa1 FPS 1, gather 1 (new_xyz), grouped xyz 3; sa2 the
    # same plus 3 gathers of its input features
    want = {**_NONE, "fps": 4, "ball_query_group_xyz": 12,
            "ball_query_multi": 4, "gather_rows": 10}
    check(got == want, "the unfused layers launched ball_query_group_xyz 3 "
          "times each (FPS once, gather once plus once per radius for "
          "features), ball_query_multi once per radius set, ball_query "
          "never")

    for key, lg in run.items():
        if isinstance(key, tuple) and key[0] in MSG_PER_FWD:
            name, _, b = key
            shape = (b, PART_N, 50) if name == PART_MSG else (b, NUM_CLASSES)
            check(lg.shape == shape and bool(np.isfinite(lg).all()),
                  f"{key}: shape {lg.shape}, finite")
    check(run["votes"].shape == (16, NUM_CLASSES)
          and bool(np.isfinite(run["votes"]).all()),
          "cls_msg 12-vote logits: (16, 40), finite")

    # kernel path vs the same requests on the plain versions at B <= 16
    # (identical indices, exact gathers: expected difference 0; bound 1e-5
    # of the range for a cuBLAS algorithm choice that might differ)
    with config.default_impl("torch"):
        for (name, dt), sv in preds.items():
            for b in (b for b in MSG_REQS[name] if b <= 16):
                want = (sv.pred(parts[:b], labels[:b]) if name == PART_MSG
                        else sv.pred(clouds[:b]))
                err, scale, ok = close(run[(name, dt, b)], want, 1e-5)
                agree = bool((run[(name, dt, b)].argmax(-1)
                              == want.argmax(-1)).all())
                check(ok and agree, f"{name} {dt} B={b}: kernel vs plain max "
                      f"abs diff {err:.3e} (logit range {scale:.3f}), argmax "
                      "agrees")
        for lv, multi in run["multi"]:
            want = grouping.ball_query_multi_plain(
                lv["radii"], lv["nsamples"], lv["xyz"], lv["new_xyz"])
            check(all(torch.equal(a, c) and torch.equal(b, d)
                      for (a, b), (c, d) in zip(multi, want)),
                  f"query_ball_point_multi {lv['tag']} radii {lv['radii']}: "
                  "bit-identical to the plain version")
    for name in MSG_PER_FWD:
        cpu = Predictor(name, sds[name], dtype=torch.float32, device="cpu")
        want = (cpu(parts[:2], labels[:2]) if name == PART_MSG
                else cpu(clouds[:2]))
        err, scale, ok = close(run[(name, "f32", 16)][:2], want, 1e-4)
        check(ok, f"{name} f32 on the card vs the CPU, 2 inputs: max abs "
              f"diff {err:.3e} (range {scale:.3f})")
        b = max(b for b in MSG_REQS[name] if b <= 64)
        err, scale, ok = close(run[(name, "bf16", b)], run[(name, "f32", b)],
                               0.05)
        check(ok, f"{name} bf16 vs f32, {b} inputs: max abs diff {err:.3e} "
              f"(range {scale:.3f})")

    # the unfused layers against the fused ones, same weights and inputs:
    # f32 within the JAX test's rtol 1e-4 / atol 3e-5
    # (tests/test_models.py:203-220), bf16 within 2% of the range
    for layer in ("sa1", "sa2"):
        for dt in ("f32", "bf16"):
            want, got = (t.float().cpu().numpy() for t in run[(layer, dt)])
            err = float(np.abs(got - want).max())
            scale = float(np.abs(want).max())
            if dt == "f32":
                ok = bool(np.allclose(got, want, rtol=1e-4, atol=3e-5))
                bound = "rtol 1e-4, atol 3e-5"
            else:
                ok = err <= 0.02 * scale
                bound = "2% of the range"
            check(ok, f"cls_msg {layer} {dt}, B=16: unfused layer vs fused, "
                  f"max abs diff {err:.3e} (range {scale:.3f}), within "
                  f"{bound}")
    torch.cuda.synchronize()


def scanned_points(torch, idx, cnt, n: int):
    """Per query, the points a scan reads up to its nsample-th hit (all n
    when the ball holds fewer)."""
    ns = idx.shape[-1]
    return torch.where(cnt == ns, idx[..., -1] + 1, torch.full_like(cnt, n))


def time_msg(torch, dev, gpu: str, levels: list, preds: dict, clouds, parts,
             labels, rows: dict) -> None:
    """Phase 15: the two new kernels per launch at B=16 beside their
    bounds, their plain versions and the launches of the default path they
    replace; the MSG forwards at B=16 and 64; where a bf16 B=16 forward's
    device time goes."""
    from pointnet2_tpu_torch.ops import grouping

    log(f"phase 15: ball_query_group_xyz and ball_query_multi per launch at "
        f"B=16 on {gpu} (kernels with the queue pre-filled, plain with the "
        "host in the loop); the table holds cls_msg's two MSG layers")
    for lv in levels:
        xyz, new_xyz = lv["xyz"], lv["new_xyz"]
        B, n = xyz.shape[:2]
        M = new_xyz.shape[1]
        in_bytes = (xyz.numel() + new_xyz.numel()) * 4
        scans, per_radius = [], []
        multi_bytes = in_bytes
        for r, ns in zip(lv["radii"], lv["nsamples"]):
            idx = torch.empty((B, M, ns), dtype=torch.int32, device=dev)
            cnt = torch.empty((B, M), dtype=torch.int32, device=dev)
            grp = torch.empty((B, M, ns, 3), device=dev)
            rows_out = torch.empty((B, M * ns, 3), device=dev)
            ms = event_ms(torch, lambda: grouping.launch_ball_query_group_xyz(
                r, xyz, new_xyz, idx, cnt, grp), 50, prefill=True)
            plain = event_ms(
                torch, lambda: grouping.ball_query_group_xyz_plain(
                    r, ns, xyz, new_xyz), 5)

            def two_launches():
                grouping.launch_ball_query(r, xyz, new_xyz, idx, cnt)
                grouping.launch_gather_rows(xyz, idx.view(B, M * ns),
                                            rows_out)

            pair = event_ms(torch, two_launches, 50, prefill=True)
            alone = event_ms(torch, lambda: grouping.launch_ball_query(
                r, xyz, new_xyz, idx, cnt), 50, prefill=True)
            scanned = scanned_points(torch, idx, cnt, n)
            scans.append(scanned)
            byts = in_bytes + (idx.numel() + cnt.numel() + grp.numel()) * 4
            bound = roofline(int(scanned.sum()) * 9, byts)
            shape = f"{lv['tag']} r={r} ns={ns}"
            if lv["model"] == CLS_MSG:
                add_time(rows, "ball_query_group_xyz", shape, ms, plain, bound)
            else:
                log(f"  {'ball_query_group_xyz':<12} {shape:<44} kernel "
                    f"{ms:.6f} ms  plain {plain:.6f} ms  bound "
                    f"{bound[0]:.6f} ms ({bound[1]})")
            log(f"   the two launches it replaces (ball_query + gather_rows "
                f"of xyz): {pair:.6f} ms; this kernel {ms / pair:.2f}x that;"
                f" the ball query alone (row 2, same walk without grouped):"
                f" {alone:.6f} ms, this kernel {ms / alone:.2f}x that")
            multi_bytes += (idx.numel() + cnt.numel()) * 4
            per_radius.append((r, idx, cnt))

        outs = tuple((torch.empty_like(i), torch.empty_like(c))
                     for _, i, c in per_radius)
        radii, nss = lv["radii"], lv["nsamples"]
        ms = event_ms(torch, lambda: grouping.launch_ball_query_multi(
            radii, xyz, new_xyz, outs), 50, prefill=True)
        plain = event_ms(torch, lambda: grouping.ball_query_multi_plain(
            radii, nss, xyz, new_xyz), 5)

        def each_radius():
            for r, i, c in per_radius:
                grouping.launch_ball_query(r, xyz, new_xyz, i, c)

        separate = event_ms(torch, each_radius, 50, prefill=True)
        # one squared distance (8 operations) a point up to the farthest
        # scan of the radii, and one compare a point per radius still open
        farthest = torch.stack(scans).amax(0)
        ops_ = int(farthest.sum()) * 8 + sum(int(s.sum()) for s in scans)
        bound = roofline(ops_, multi_bytes)
        shape = f"{lv['tag']} radii {radii}"
        if lv["model"] == CLS_MSG:
            add_time(rows, "ball_query_multi", shape, ms, plain, bound)
        else:
            log(f"  {'ball_query_multi':<12} {shape:<44} kernel {ms:.6f} ms  "
                f"plain {plain:.6f} ms  bound {bound[0]:.6f} ms ({bound[1]})")
        log(f"   the {len(radii)} per-radius ball_query launches it replaces:"
            f" {separate:.6f} ms; one multi-radius launch {ms / separate:.2f}x"
            " that")

    log(f"phase 15: MSG serving times (host clock, numpy in and out) on {gpu}")
    host = {}
    for name in (CLS_MSG, PART_MSG):
        for dt in ("bf16", "f32"):
            pred = preds[(name, dt)].pred
            for b in MSG_TIMED:
                def call(b=b):
                    return (pred(parts[:b], labels[:b]) if name == PART_MSG
                            else pred(clouds[:b]))

                ms = host[name, dt, b] = host_ms(torch, call, 10)
                torch.cuda.reset_peak_memory_stats()
                call()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                log(f"  {name} {dt} B={b}: {ms:.3f} ms, {b / ms * 1e3:.1f} "
                    f"inputs/s, peak device memory {peak:.2f} GiB")
    log(f"phase 15: where a bf16 B=16 forward's device time goes "
        f"(torch.profiler) on {gpu}")
    for name in (CLS_MSG, PART_MSG):
        pred = preds[(name, "bf16")].pred
        fn = ((lambda: pred(parts[:16], labels[:16])) if name == PART_MSG
              else (lambda: pred(clouds[:16])))
        profile_device(torch, fn, 3, f"{name} bf16 B=16", "forward",
                       host_us=host[name, "bf16", MSG_TIMED[0]] * 1e3)


# --- the fused SA chain -------------------------------------------------------

CLS_SSG = "pointnet2_cls_ssg"
FUSED_MODELS = (CLS_SSG, CLS_MSG, SEM, PART, PART_MSG)
FUSED_REQS = (16, 64)  # phase 17's requests and phase 18's timed batches
# launches per forward of each model's main path with config.fused_mlp on:
# the launches of the default path, plus the fused chain's dense passes (one
# per dense after the lifted first) and pooled tails (one per fused chain)
FUSED_PER_FWD = {
    CLS_SSG: {**_NONE, "fps": 2, "ball_query": 2, "gather_rows": 4,
              "fused_dense": 4, "fused_pool": 2},
    CLS_MSG: {**MSG_PER_FWD[CLS_MSG], "fused_dense": 12, "fused_pool": 6},
    SEM: {**_NONE, **SEG_PER_FWD[SEM], "fused_dense": 8, "fused_pool": 4},
    PART: {**_NONE, **SEG_PER_FWD[PART], "fused_dense": 4, "fused_pool": 2},
    PART_MSG: {**MSG_PER_FWD[PART_MSG], "fused_dense": 10, "fused_pool": 5},
}
RAGGED = (1000, 196, 40)  # rows, Cin, Cout of phase 16's ragged shape
AFFINE_C = 131  # phase 16's affine tail off the 16-byte vector


def fused_chains(torch, models: dict, B: int = 16) -> list:
    """Every chain that takes the fused route in these models (the
    fuse_first layout's max-pooled SharedMLPs of >= 2 layers): (tag, the
    SharedMLP, its rows B*npoint*nsample, nsample)."""
    from pointnet2_tpu_torch.nn import SetAbstraction, SetAbstractionMSG

    out = []
    for name, model in models.items():
        for lname, mod in model.named_children():
            if (isinstance(mod, SetAbstraction) and mod.fuse_first
                    and not mod.group_all and mod.pooling == "max"):
                scales = [(lname, mod.mlp_mod, mod.npoint, mod.nsample)]
            elif isinstance(mod, SetAbstractionMSG) and mod.fuse_first:
                scales = [(f"{lname}.{i}", m, mod.npoint, ns)
                          for i, (m, ns) in enumerate(zip(mod.mlp_mods,
                                                          mod.nsample_list))]
            else:
                continue
            for tag, mlp, npoint, ns in scales:
                if len(mlp.blocks) >= 2:
                    out.append((f"{name[10:]} {tag}", mlp, B * npoint * ns,
                                ns))
    return out


def mlp_affines(mlp) -> list:
    """The eval BN of each block of a SharedMLP as its f32 affine (a, b)."""
    from pointnet2_tpu_torch.ops import fused_mlp

    return [fused_mlp.bn_affine(b.norm.weight, b.norm.bias,
                                b.norm.running_mean, b.norm.running_var,
                                b.norm.epsilon) for b in mlp.blocks]


def check_dense(torch, tag, x, a, b, w, bias, check: Checks,
                errs: dict) -> torch.Tensor:
    """One dense pass, kernel against plain: y within 1e-5 of max|y| of
    plain (f32) or `y_ok` (bf16), the statistics against their exact sums
    (`sum_ok`), two launches bitwise equal; returns the kernel's y."""
    from pointnet2_tpu_torch.ops import fused_mlp

    y, s, ss = fused_mlp.fused_dense_kernel(x, a, b, w, bias, True)
    _, s2, ss2 = fused_mlp.fused_dense_kernel(x, a, b, w, bias, True)
    want, _, _ = fused_mlp.dense_fwd_plain(x, a, b, w, bias)
    d = (y.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    if x.dtype == torch.float32:
        errs["fused_dense"] = max(errs["fused_dense"], float(d.max()))
        ok = float(d.max()) <= 1e-5 * scale
        bound = "1e-5 of max|y|"
    else:
        ok = y_ok(torch, y, x, a, b, w, bias)
        over = float((d > bf16_ulp(torch, want.float())).float().mean())
        bound = (f"one bf16 ulp of the exact product plus the f32 "
                 f"accumulation bound ({over:.2e} of elements more than one "
                 "ulp from plain)")
    # statistics: f32 sums of the kernel's rounded y and its f32 squares,
    # against their exact sums (`sum_ok`)
    R = x.shape[0]
    y1, y2 = y.double(), (y.float() * y.float()).double()
    sums = ((s, y1.sum(0), y1.abs().sum(0)), (ss, y2.sum(0), y2.sum(0)))
    stats_ok = all(sum_ok(*t) for t in sums)
    same = torch.equal(s, s2) and torch.equal(ss, ss2)
    check(ok and stats_ok and same,
          f"fused_dense {tag} {str(x.dtype)[6:]} ({R}, {x.shape[1]}) -> "
          f"{w.shape[0]}: max abs diff {float(d.max()):.3e} (max|y| "
          f"{scale:.3f}, {float((d > 0).float().mean()):.4%} of elements "
          f"differ) within {bound}; statistics within {SUM_RTOL} of "
          f"sum|terms| of the exact sums {stats_ok} (errors "
          f"{', '.join(f'{sum_err(*t):.2e}' for t in sums)} of it), two "
          f"launches bitwise equal {same}")
    return y


def check_tails(torch, tag, y3d, a, b, check: Checks, errs: dict) -> None:
    """The pooled and affine tails on the same y, bit for bit."""
    from pointnet2_tpu_torch.ops import fused_mlp

    view = torch.int16 if y3d.dtype == torch.bfloat16 else torch.int32
    y2d = y3d.reshape(-1, y3d.shape[-1])
    for name, got, want in (
            ("fused_pool", fused_mlp.fused_pool_kernel(y3d, a, b),
             fused_mlp.pool_fwd_plain(y3d, a, b)),
            ("fused_affine", fused_mlp.fused_affine_kernel(y2d, a, b),
             fused_mlp.affine_fwd_plain(y2d, a, b))):
        errs[name] = max(errs[name],
                         float((got.float() - want.float()).abs().max()))
        check(torch.equal(got.view(view), want.view(view)),
              f"{name} {tag} {str(y3d.dtype)[6:]} {tuple(y3d.shape)}: bit "
              "for bit the plain version")


def check_fused_kernels(torch, dev, chains: list, check: Checks,
                        errs: dict) -> int:
    """Phase 16: each fused kernel against its plain version along every
    fused chain at B=16, f32 and bf16, and at the ragged shape. Returns the
    affine kernel's launches (it runs on no model path)."""
    from pointnet2_tpu_torch import ops

    log("phase 16: the fused chain's kernels vs plain versions on the card, "
        "every fused chain of the five models at B=16")
    before = ops.KERNELS["fused_affine"].launches
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    with torch.no_grad():
        for tag, mlp, R, ns in chains:
            check_chain(torch, dev, g, tag, mlp, R, ns, check, errs)
        check_ragged(torch, dev, g, check, errs)
    torch.cuda.synchronize()
    return ops.KERNELS["fused_affine"].launches - before


def check_chain(torch, dev, g, tag, mlp, R, ns, check, errs) -> None:
    """One fused chain from random inputs, f32 and bf16: each dense pass on
    the previous one's output, then both tails on the last."""
    affines = mlp_affines(mlp)
    for dt in (torch.bfloat16, torch.float32):
        cur = torch.randn((R, mlp.blocks[0].dense.out_features), generator=g,
                          device=dev).to(dt)
        for (a, b), block in zip(affines, mlp.blocks[1:]):
            cur = check_dense(torch, tag, cur, a, b, block.dense.weight,
                              block.dense.bias, check, errs)
        a, b = affines[-1]
        check_tails(torch, tag, cur.reshape(R // ns, ns, -1), a, b, check,
                    errs)


def check_ragged(torch, dev, g, check, errs) -> None:
    """The kernels at a shape no model has: rows, Cin and Cout off every
    tile."""
    R, cin, cout = RAGGED
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn((R, cin), generator=g, device=dev).to(dt)
        a = torch.randn(cin, generator=g, device=dev)
        b = 0.1 * torch.randn(cin, generator=g, device=dev)
        w = torch.randn((cout, cin), generator=g, device=dev) / cin ** 0.5
        bias = 0.1 * torch.randn(cout, generator=g, device=dev)
        y = check_dense(torch, "ragged", x, a, b, w, bias, check, errs)
        a = torch.randn(cout, generator=g, device=dev)
        b = 0.1 * torch.randn(cout, generator=g, device=dev)
        check_tails(torch, "ragged", y.reshape(R // 8, 8, cout), a, b, check,
                    errs)
        check_affine_unaligned(torch, "ragged", y, a, b, check, errs)
        c = AFFINE_C
        check_affine_unaligned(
            torch, f"{R} x {c}", torch.randn((R, c), generator=g,
                                             device=dev).to(dt),
            torch.randn(c, generator=g, device=dev),
            0.1 * torch.randn(c, generator=g, device=dev), check, errs)


def check_affine_unaligned(torch, tag, y2d, a, b, check: Checks,
                           errs: dict) -> None:
    """The affine tail on y one element into its storage (rows off the
    16-byte boundary: the element-by-element route), bit for bit the plain
    version on the same values."""
    from pointnet2_tpu_torch.ops import fused_mlp

    buf = torch.empty(y2d.numel() + 1, dtype=y2d.dtype, device=y2d.device)
    y = buf[1:].view(y2d.shape)
    y.copy_(y2d)
    got = fused_mlp.fused_affine_kernel(y, a, b)
    want = fused_mlp.affine_fwd_plain(y2d, a, b)
    view = torch.int16 if y.dtype == torch.bfloat16 else torch.int32
    errs["fused_affine"] = max(errs["fused_affine"],
                               float((got.float() - want.float()).abs().max()))
    check(torch.equal(got.view(view), want.view(view)),
          f"fused_affine {tag} {str(y.dtype)[6:]} {tuple(y.shape)} at storage "
          "offset 1: bit for bit the plain version")


def fused_request(name: str, data: dict, b: int) -> tuple:
    """A request of b inputs to a model: its points (and labels)."""
    if name == PART_MSG:
        return data[PART_MSG][:b], data["labels"][:b]
    return (data[name][:b],)


def drive_fused(torch, preds: dict, data: dict) -> dict:
    """Phase 17's main-path runs with config.fused_mlp on, one per model
    from the launch counters' zero: requests of 16 and 64 in bf16 and f32.
    Returns outputs, launches and forward calls by model."""
    from pointnet2_tpu_torch import config, ops

    out = {"launches": {}, "forwards": {}}
    with config.fused_mlp(True):
        for name in FUSED_MODELS:
            for w in ops.KERNELS.values():
                w.launches = 0
            before = {dt: preds[(name, dt)].calls[0] for dt in ("bf16", "f32")}
            for dt in ("bf16", "f32"):
                for b in FUSED_REQS:
                    out[(name, dt, b)] = preds[(name, dt)].pred(
                        *fused_request(name, data, b))
            torch.cuda.synchronize()
            out["launches"][name] = {k: w.launches
                                     for k, w in ops.KERNELS.items()}
            out["forwards"][name] = sum(preds[(name, dt)].calls[0] - before[dt]
                                        for dt in ("bf16", "f32"))
    return out


def check_fused(torch, preds: dict, run: dict, data: dict, sds: dict,
                check: Checks) -> None:
    """Phase 17's checks on the main-path runs."""
    from pointnet2_tpu_torch import Predictor, config

    for name, per in FUSED_PER_FWD.items():
        n = run["forwards"][name]
        got = run["launches"][name]
        log(f"  {name}: launches in its fused main-path run ({n} forwards): "
            f"{got}")
        check(all(got[k] == per[k] * n for k in per),
              f"{name}: launches per forward {per['fused_dense']} fused_dense, "
              f"{per['fused_pool']} fused_pool, 0 fused_affine, and the "
              "default path's point kernels")
    for key, lg in run.items():
        if isinstance(key, tuple):
            name, _, b = key
            shape = {CLS_SSG: (b, NUM_CLASSES), CLS_MSG: (b, NUM_CLASSES),
                     SEM: (b, SEM_N, 21), PART: (b, PART_N, 50),
                     PART_MSG: (b, PART_N, 50)}[name]
            check(lg.shape == shape and bool(np.isfinite(lg).all()),
                  f"fused {key}: shape {lg.shape}, finite")
    # B=16 against the plain versions with the gate on (the same route, the
    # kernels' summation order against cuBLAS's) and against the unfused
    # route on the card (the BN affine reassociates): f32 within 1e-4 of
    # the logit range, bf16 within 2%
    tol = {"f32": 1e-4, "bf16": 0.02}
    for name in FUSED_MODELS:
        for dt in ("bf16", "f32"):
            pred = preds[(name, dt)].pred
            req = fused_request(name, data, 16)
            with config.fused_mlp(True), config.default_impl("torch"):
                plain = pred(*req)
            unfused = pred(*req)
            got = run[(name, dt, 16)]
            for what, want in (("plain versions", plain),
                               ("unfused route", unfused)):
                err, scale, ok = close(got, want, tol[dt])
                agree = float((got.argmax(-1) == want.argmax(-1)).mean())
                check(ok, f"{name} {dt} B=16 fused vs {what}: max abs diff "
                      f"{err:.3e} (range {scale:.3f}), argmax agreement "
                      f"{agree:.4f}")
    # f32 on the card vs the CPU's plain fused route, 2 inputs
    with config.fused_mlp(True):
        for name in FUSED_MODELS:
            cpu = Predictor(name, sds[name], dtype=torch.float32, device="cpu")
            err, scale, ok = close(run[(name, "f32", 16)][:2],
                                   cpu(*fused_request(name, data, 2)), 1e-4)
            check(ok, f"{name} f32 fused on the card vs the CPU, 2 inputs: "
                  f"max abs diff {err:.3e} (range {scale:.3f})")
    torch.cuda.synchronize()


def dense_bound(R: int, cin: int, cout: int, isz: int) -> tuple:
    """x read and y written in the activation type, W, bias, a, b in f32;
    2*R*Cin*Cout operations at the tensor cores' bf16 or the f32 FMA rate."""
    byts = (R * cin + R * cout) * isz + (cin * cout + cout + 2 * cin) * 4
    rate = BF16_TENSOR_OPS_PER_S if isz == 2 else F32_FMA_OPS_PER_S
    return roofline(2 * R * cin * cout, byts, rate)


def time_fused_kernels(torch, dev, gpu: str, chains: list,
                       rows: dict) -> None:
    """Phase 18a: the three kernels per launch at a cls_ssg forward's
    shapes at B=16 (the table holds bf16), their bounds, plain versions and
    the unfused PyTorch ops each stands for (row 10: affine, relu, cast,
    addmm; row 11: relu(y*a + b), cast, amax; row 12: the affine and relu,
    cast), and row 10's bare bf16 addmm of its rounded operands, timed here
    only."""
    log(f"phase 18: fused kernels per launch at a cls_ssg forward's shapes, "
        f"B=16, on {gpu} (kernel and unfused ops with the queue pre-filled, "
        "plain with the host in the loop)")
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float32):
            time_cls_ssg_chains(torch, dev, g, dt, chains, rows)


def time_cls_ssg_chains(torch, dev, g, dt, chains: list, rows: dict) -> None:
    """Phase 18a in one activation type: each dense pass, then both tails
    on the last one's output, of cls_ssg's two fused chains."""
    from pointnet2_tpu_torch.ops import fused_mlp

    isz = 2 if dt == torch.bfloat16 else 4
    for tag, mlp, R, ns in chains:
        if not tag.startswith("cls_ssg"):
            continue
        affines = mlp_affines(mlp)
        x = torch.randn((R, mlp.blocks[0].dense.out_features), generator=g,
                        device=dev).to(dt)
        for (a, b), block in zip(affines, mlp.blocks[1:]):
            w, bias = block.dense.weight, block.dense.bias
            cin, cout = w.shape[1], w.shape[0]
            y = torch.empty((R, cout), dtype=dt, device=dev)
            w16 = fused_mlp.dense_w16(x, w)
            w_t, bias_t = w.to(dt).t(), bias.to(dt)
            ms = event_ms(torch, lambda: fused_mlp.launch_fused_dense(
                x, a, b, w, bias, y, w16), 50, prefill=True)
            plain = event_ms(torch, lambda: fused_mlp.dense_fwd_plain(
                x, a, b, w, bias), 10)
            library = event_ms(torch, lambda: torch.addmm(
                bias_t, torch.relu(x.float() * a + b).to(dt), w_t), 50,
                prefill=True)
            emit(torch, rows, "fused_dense", f"{tag} ({R},{cin})->{cout}",
                 dt, ms, plain, dense_bound(R, cin, cout, isz), library)
            if dt == torch.bfloat16:  # a yardstick, logged only
                z = fused_mlp.affine_fwd_plain(x, a, b)
                mm = event_ms(torch, lambda: torch.addmm(bias_t, z, w_t), 50,
                              prefill=True)
                log(f"   fused_dense {tag} ({R},{cin})->{cout}: the bare bf16 "
                    f"torch.addmm of the rounded z and W at its shapes "
                    f"{mm:.6f} ms")
            x = y
        a, b = affines[-1]
        C = x.shape[1]
        y3d = x.reshape(R // ns, ns, C)
        out = torch.empty((R // ns, C), dtype=dt, device=dev)
        ms = event_ms(torch, lambda: fused_mlp.launch_fused_pool(
            y3d, a, b, out), 50, prefill=True)
        plain = event_ms(torch, lambda: fused_mlp.pool_fwd_plain(y3d, a, b),
                         10)
        library = event_ms(torch, lambda: torch.relu(
            y3d.float() * a + b).to(dt).amax(1), 50, prefill=True)
        byts = (y3d.numel() + out.numel()) * isz + 2 * C * 4
        emit(torch, rows, "fused_pool", f"{tag} {tuple(y3d.shape)}", dt, ms,
             plain, roofline(0, byts), library)
        out = torch.empty_like(x)
        ms = event_ms(torch, lambda: fused_mlp.launch_fused_affine(
            x, a, b, out), 50, prefill=True)
        plain = event_ms(torch, lambda: fused_mlp.affine_fwd_plain(x, a, b),
                         10)
        library = event_ms(torch, lambda: torch.relu(
            x.float() * a + b).to(dt), 50, prefill=True)
        emit(torch, rows, "fused_affine", f"{tag} {tuple(x.shape)}", dt, ms,
             plain, roofline(0, 2 * x.numel() * isz + 2 * C * 4), library)


def emit(torch, rows: dict, name: str, shape: str, dt, ms, plain, bound,
         library):
    """bf16 times go into the table (a bf16 forward's launches), f32 ones
    into the log only."""
    if dt == torch.bfloat16:
        add_time(rows, name, f"{shape} bf16", ms, plain, bound, library)
    else:
        log(f"  {name:<12} {shape + ' f32':<44} kernel {ms:.6f} ms  plain "
            f"{plain:.6f} ms  bound {bound[0]:.6f} ms ({bound[1]}) library "
            f"{library:.6f} ms")
    log(f"   {name} {shape}: {bound[0] / ms:.1%} of the {bound[1]} roofline;"
        f" kernel {ms / library:.2f}x the unfused ops")


def time_fused_forwards(torch, gpu: str, preds: dict, data: dict) -> None:
    """Phase 18b: fused against unfused forwards of the five models at B=16
    and 64 in bf16 and f32: host ms (median of 5), device time (torch
    profiler, busy us per forward), peak device memory; then where a fused
    bf16 B=16 forward's device time goes."""
    from pointnet2_tpu_torch import config

    log(f"phase 18: fused vs unfused forwards (host clock, numpy in and out; "
        f"device time by torch.profiler) on {gpu}")
    host = {}
    for name in FUSED_MODELS:
        for dt in ("bf16", "f32"):
            pred = preds[(name, dt)].pred
            for b in FUSED_REQS:
                req = fused_request(name, data, b)
                line = []
                for route in ("unfused", "fused"):
                    with config.fused_mlp(route == "fused"):
                        ms = host[name, dt, b, route] = host_ms(
                            torch, lambda: pred(*req), 5)
                        kernels, _, _, _ = trace_device(
                            torch, lambda: pred(*req), 2)
                        torch.cuda.reset_peak_memory_stats()
                        pred(*req)
                        torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated() / 2 ** 30
                    busy = sum(r[0] for r in kernels)
                    line.append(f"{route} {ms:.3f} ms host, {busy:.1f} us "
                                f"device, {sum(r[1] for r in kernels):.0f} "
                                f"ops, peak {peak:.2f} GiB")
                log(f"  {name} {dt} B={b}: " + "; ".join(line))
    log(f"phase 18: where a fused bf16 B=16 forward's device time goes "
        f"(torch.profiler) on {gpu}")
    with config.fused_mlp(True):
        for name in FUSED_MODELS:
            pred = preds[(name, "bf16")].pred
            b = FUSED_REQS[0]
            req = fused_request(name, data, b)
            profile_device(torch, lambda: pred(*req), 3,
                           f"{name} fused bf16 B={b}", "forward",
                           host_us=host[name, "bf16", b, "fused"] * 1e3)


# --- the fused SA chain in train mode -------------------------------------------

TRAIN_MODELS = {CLS_SSG: 2, CLS_MSG: 6}  # fused chains a train step
BWD = ("fused_top_stats", "fused_dense_bwd", "fused_first_bwd")
# phase 19's ragged chain: groups, S, Ck, Cp (1000 rows, 196 -> 40)
RAGGED_BWD = (125, 8, 40, 196)
# phase 20's fused layers, kernels vs plain (`fused_layer_errs`), on these
# inputs: (B, N, kind). The limits stand 1.8x or more above the largest
# readings of cls_ssg's layers on an H100 (PERF.md; a bf16 gradient reads
# up to 2.7e-2 since the bf16 dense pass adds in the tensor cores' order,
# no longer cuBLAS's), and 1.79x above sem_seg's four (phase 22, 2.8e-2);
# in f32 most output elements differ in their last bits, so that share is
# not bounded. A zeroed or scaled gradient reads 1 or more.
LAYER_INPUTS = ((16, N_POINT, "clouds"), (16, N_POINT, "uniform"),
                (4, 512, "clouds"), (4, 512, "uniform"))
LAYER_LIMITS = {
    "f32": {"outputs differ": 1.0, "output": 1e-5, "gradient": 3e-2,
            "running statistics": 1e-5},
    "bf16": {"outputs differ": 1e-2, "output": 2e-2, "gradient": 5e-2,
             "running statistics": 1e-4}}


def bwd_per_step(chains: int) -> dict:
    """Launches of the chain's kernels per train step with the gate on:
    every chain of these models has two denses after the lifted first."""
    return {"fused_dense": 2 * chains, "fused_pool": chains,
            "fused_top_stats": chains, "fused_dense_bwd": 2 * chains,
            "fused_first_bwd": chains}


SUM_RTOL = 1e-4


def sum_ok(got, exact, abs_sum, nonzero: bool = True) -> bool:
    """A kernel's f32 column sums against the exact (float64) sums of the
    plain version's f32 terms: within SUM_RTOL of sum|terms|. The kernels'
    longest chain of roundings at these shapes is under 1200 (the
    statistics' 64-row blocks, then up to 16384 blocks; a pooled db's 8
    items of up to 128 rows; a dW partial of 1024 rows: 1024 f32 additions
    on the CUDA cores, 64 mma steps on the tensor cores, each of which adds
    16 exact products and the accumulator with truncation, within about
    17 * 2^-23 of the running sum|terms|; then the slabs' sum), so a right
    sum strays at most 1200 * 2^-24 = 7.2e-5 of it; a sum of R
    random-sign terms is about sum|terms| / sqrt(R), 2e-3 of it at
    R = 262144 and 1e-3 at 1048576 (part_seg_msg SA1's third scale). With
    `nonzero`, some exact sum must lie outside the bound, so that a zeroed
    sum fails (db is zero in exact arithmetic: train-mode BN follows the
    dense, and its sum dy = -gr * m2 * sum yhat = 0)."""
    bound = SUM_RTOL * abs_sum
    return (bool(((got.double() - exact).abs() <= bound).all())
            and not (nonzero and bool((exact.abs() <= bound).all())))


def first_occurrence_case(torch, G: int, S: int, C: int, dtype, seed: int,
                          nan: bool = False):
    """Row 13's inputs on which only the first-occurrence argmax over S
    passes `sum_ok`: y (G, S, C), g (G, C) of dtype and the (7, C) f32 pack
    p, on the CPU. With a = 2^-40, b = 1, z = T(relu(y*a + b)) is exactly 1
    on the tied rows, where y is drawn from [1, 2) (about 30% of each
    group's rows per channel, at least two), and 0 where y = -2^41, so the
    tied rows' y differ; mu = 0 and r = 64 make picking any tied row but
    the first move T2 by about 20|g|, where `sum_ok`'s bound is about
    0.01|g| a group. With `nan`, the channels c % 4 == 0 hold one NaN a
    group: at row 0 (before the group's first tied row) in even groups, at
    row S-1 (after it) in odd ones; the NaN is the pick, its T2 NaN."""
    rng = np.random.default_rng(seed)
    tie = rng.random((G, S, C)) < 0.3
    tie |= rng.random((G, S, C)).argsort(1) < 2
    y = np.where(tie, rng.uniform(1.0, 2.0, (G, S, C)),
                 -2.0 ** 41).astype(np.float32)
    if nan:
        y[0::2, 0, 0::4] = np.nan
        y[1::2, S - 1, 0::4] = np.nan
    g = rng.standard_normal((G, C)).astype(np.float32)
    p = np.zeros((7, C), np.float32)
    p[0], p[1], p[3], p[4] = 2.0 ** -40, 1.0, 64.0, 1.0
    return (torch.from_numpy(y).to(dtype), torch.from_numpy(g).to(dtype),
            torch.from_numpy(p))


def g_ok(torch, gp, dyc, w) -> bool:
    """bf16 g_{k-1} = bf16(dyc @ bf16(W)), dyc (R, Ck), against the exact
    (float64) product of its rounded operands: each element within one
    bf16 ulp of it plus Ck * 2^-22 * sum|terms|, the bound of an f32
    accumulation on the tensor cores (Ck/16 mma steps, each within about
    17 * 2^-23 of the running sum|terms|). One bf16 ulp of the plain
    version would hold only the plain version's own summation order:
    where the terms cancel, cuBLAS's sequential f32 sum and the mma tiles'
    both miss the exact one by more than an ulp of the small result, at a
    few elements per million (tests/test_torch_dense_bwd_order.py shows it
    on the CPU). A zeroed, scaled or partial product fails."""
    wc = w.to(gp.dtype).double()
    d = dyc.double()
    exact = d @ wc
    bound = (bf16_ulp(torch, exact)
             + dyc.shape[1] * 2.0 ** -22 * (d.abs() @ wc.abs()))
    return bool(((gp.double() - exact).abs() <= bound).all())


def y_ok(torch, y, x, a, b, w, bias) -> bool:
    """bf16 y = bf16(z @ bf16(W)^T + bias), z = bf16(relu(x*a + b)) (the
    plain version's z), x (R, Cin), against the exact (float64) product of
    the rounded z and W plus bias: each element within one bf16 ulp of it
    plus Cin * 2^-22 * sum|terms|, the bound of an f32 accumulation on the
    tensor cores (Cin/16 mma steps, each within about 17 * 2^-23 of the
    running sum|terms|), as `g_ok` holds row 14's g. One bf16 ulp of the
    plain version would hold only cuBLAS's own summation order
    (tests/test_torch_dense_fwd_order.py). A zeroed, scaled, partial or
    bias-less y fails."""
    from pointnet2_tpu_torch.ops import fused_mlp

    z = fused_mlp._affine_relu(x, a, b).double()  # relu: >= 0
    wc = w.to(y.dtype).double()
    exact = torch.addmm(bias.double(), z, wc.t())
    bound = (bf16_ulp(torch, exact)
             + x.shape[1] * 2.0 ** -22 * (z @ wc.abs().t()))
    return bool(((y.double() - exact).abs() <= bound).all())


def sum_err(got, exact, abs_sum) -> float:
    """The largest |got - exact| / sum|terms| over the columns."""
    return float(((got.double() - exact).abs()
                  / abs_sum.clamp_min(1e-300)).max())


def saved_chain(torch, dev, g, mlp, R: int, dt):
    """A train-mode chain's saved tensors from random input rows, through
    the plain forward on the card: the pre-BN activations ys (R, C_k) of T
    and each BN's (scale, bias, batch mean, batch var)."""
    from pointnet2_tpu_torch.ops import fused_mlp

    eps = mlp.blocks[0].norm.epsilon
    ys = [torch.randn((R, mlp.blocks[0].dense.out_features), generator=g,
                      device=dev).to(dt)]
    stats = []
    for k, block in enumerate(mlp.blocks):
        yf = ys[-1].float()
        mean = yf.mean(0)
        var = torch.clamp_min(yf.square().mean(0) - mean.square(), 0.0)
        stats.append((block.norm.weight.detach(), block.norm.bias.detach(),
                      mean, var))
        if k + 1 < len(mlp.blocks):
            a, b = fused_mlp.bn_affine(*stats[-1], eps)
            dense = mlp.blocks[k + 1].dense
            ys.append(fused_mlp.dense_fwd_plain(
                ys[-1], a, b, dense.weight.detach(), dense.bias.detach())[0])
    ws = [b.dense.weight.detach() for b in mlp.blocks[1:]]
    return ys, stats, ws


def chain_terms(torch, y, g, p, pool: bool):
    """(T1, T2) and (sum|dout|, sum|dout*yhat|) of the plain version's f32
    elementwise terms, summed exactly (float64)."""
    from pointnet2_tpu_torch.ops import fused_mlp

    if pool:
        g = fused_mlp._pooled_cotangent(y, g, p).reshape(-1, y.shape[-1])
        y = y.reshape(-1, y.shape[-1])
    dout, yhat = fused_mlp._bn_bwd_terms(y, g.float(), p)
    t1, t2 = dout.double(), (dout * yhat).double()
    return (t1.sum(0), t2.sum(0)), (t1.abs().sum(0), t2.abs().sum(0))


def check_bwd_chain(torch, dev, g, tag, ys, stats, ws, ns, check, errs):
    """One chain's backward from a random pooled cotangent, each kernel on
    the previous kernel's outputs and held to its plain version on the same
    inputs: top_stats and dense_bwd's T1/T2, dW, db against the exact sums
    of the plain version's terms (`sum_ok`; T1/T2 of the kernel's own
    g_{k-1}), g_{k-1} within 1e-5 of max|g| (f32) or `g_ok` (bf16),
    first_bwd bit for bit; every kernel twice, bitwise equal."""
    from pointnet2_tpu_torch.ops import fused_mlp as fm

    dt, R, D = ys[0].dtype, ys[0].shape[0], len(ys) - 1
    f32 = dt == torch.float32
    view = torch.int32 if f32 else torch.int16
    name = f"{tag} {str(dt)[6:]}"

    def pack(j, t1=None, t2=None):
        return fm.bn_pack(*stats[j], 1e-3, None if t1 is None else t1 / R,
                          None if t2 is None else t2 / R)

    y_top = ys[D].reshape(R // ns, ns, -1)
    gcur = torch.randn((R // ns, y_top.shape[-1]), generator=g,
                       device=dev).to(dt)
    p = pack(D)
    t1, t2 = fm.fused_top_stats_kernel(y_top, gcur, p, True)
    u1, u2 = fm.fused_top_stats_kernel(y_top, gcur, p, True)
    (w1, w2), (a1, a2) = chain_terms(torch, y_top, gcur, p, True)
    p1, p2 = fm.top_stats_plain(y_top, gcur, p, True)
    if f32:
        errs["fused_top_stats"] = max(errs["fused_top_stats"],
                                      float((t1 - p1).abs().max()),
                                      float((t2 - p2).abs().max()))
    ok = sum_ok(t1, w1, a1) and sum_ok(t2, w2, a2)
    same = torch.equal(t1, u1) and torch.equal(t2, u2)
    check(ok and same, f"fused_top_stats {name} {tuple(y_top.shape)}: T1/T2 "
          f"within {SUM_RTOL} of sum|terms| of the exact sums {ok} (error "
          f"{sum_err(t1, w1, a1):.2e} and {sum_err(t2, w2, a2):.2e} of it, "
          f"exact sums up to {sum_err(0 * t1, w1, a1):.2e} and "
          f"{sum_err(0 * t2, w2, a2):.2e}), max abs diff to plain "
          f"{float(max((t1 - p1).abs().max(), (t2 - p2).abs().max())):.3e}, "
          f"two launches bitwise equal {same}")
    for k in range(D, 0, -1):
        yk, yp = (y_top if k == D else ys[k]), ys[k - 1]
        pk, pp = pack(k, t1, t2), pack(k - 1)
        args = (yk, yp, gcur, pk, pp, ws[k - 1], k == D)
        got = fm.fused_dense_bwd_kernel(*args)
        again = fm.fused_dense_bwd_kernel(*args)
        gp, dw, db, t1, t2 = got
        rows = yp.shape[0]
        if k == D:
            dz = fm._pooled_cotangent(yk, gcur, pk).reshape(rows, -1)
        else:
            dz = gcur.float()
        dout, yhat = fm._bn_bwd_terms(yk.reshape(rows, -1), dz, pk)
        dy = fm._bn_dy(dout, yhat, pk)
        wg = fm.dense_bwd_plain(*args)[0]
        d = (gp.float() - wg.float()).abs()
        if f32:
            errs["fused_dense_bwd"] = max(errs["fused_dense_bwd"],
                                          float(d.max()))
            g_fine = float(d.max()) <= 1e-5 * float(wg.float().abs().max())
            g_what = "within 1e-5 of max|g|"
        else:
            g_fine = g_ok(torch, gp, dy.to(dt), ws[k - 1])
            over = float((d > bf16_ulp(torch, wg.float())).float().mean())
            g_what = (f"within one bf16 ulp of the exact product plus the "
                      f"f32 accumulation bound ({over:.2e} of elements more "
                      "than one ulp from plain)")
        dyc = dy.to(dt).double()
        z = fm.affine_fwd_plain(yp, pp[0], pp[1]).double()  # relu: >= 0
        (v1, v2), (b1, b2) = chain_terms(torch, yp, gp, pp, False)
        sums = ((dw, dyc.t() @ z, dyc.abs().t() @ z),
                (db, dy.double().sum(0), dy.double().abs().sum(0)),
                (t1, v1, b1), (t2, v2, b2))
        sums_ok = all(sum_ok(*s, nonzero=s[0] is not db) for s in sums)
        err = ", ".join(f"{sum_err(*s):.2e}" for s in sums)
        top = ", ".join(f"{sum_err(0 * x, w, a):.2e}" for x, w, a in sums)
        same = (torch.equal(gp.view(view), again[0].view(view))
                and all(torch.equal(x, y) for x, y in zip(got[1:],
                                                          again[1:])))
        check(g_fine and sums_ok and same,
              f"fused_dense_bwd {name} k={k} {tuple(yk.shape)} -> g "
              f"{tuple(gp.shape)}: g max abs diff to plain "
              f"{float(d.max()):.3e} ({float((d > 0).float().mean()):.4%} "
              f"differ), {g_what} {g_fine}; dW, db, "
              f"T1/T2 within {SUM_RTOL} of sum|terms| of the exact sums "
              f"{sums_ok} (errors {err} of it; exact sums up to {top}); two "
              f"launches bitwise equal {same}")
        gcur = gp
    p = pack(0, t1, t2)
    dx = fm.fused_first_bwd_kernel(ys[0], gcur, p)
    dx2 = fm.fused_first_bwd_kernel(ys[0], gcur, p)
    want = fm.first_bwd_plain(ys[0], gcur, p)
    if f32:
        errs["fused_first_bwd"] = max(errs["fused_first_bwd"], float(
            (dx - want).abs().max()))
    check(torch.equal(dx.view(view), want.view(view))
          and torch.equal(dx.view(view), dx2.view(view)),
          f"fused_first_bwd {name} {tuple(dx.shape)}: bit for bit the plain "
          "version, two launches bitwise equal")


def check_fused_bwd_kernels(torch, dev, chains: list, check: Checks,
                            errs: dict) -> None:
    """Phase 19: rows 13-15 against their plain versions along every fused
    chain of the five models at B=16 (the train path's shapes with the gate
    on: cls_ssg's and cls_msg's, and sem_seg's four, which phase 23 trains
    fused; part_seg's and part_seg_msg's, up to 1048576 rows), bf16 and
    f32, and along a ragged chain."""
    log("phase 19: the fused chain's backward kernels vs plain versions on "
        "the card, every fused chain of the five models at B=16")
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    with torch.no_grad():
        for tag, mlp, R, ns in chains:
            for dt in (torch.bfloat16, torch.float32):
                ys, stats, ws = saved_chain(torch, dev, g, mlp, R, dt)
                check_bwd_chain(torch, dev, g, tag, ys, stats, ws, ns, check,
                                errs)
        G, S, ck, cp = RAGGED_BWD
        for dt in (torch.bfloat16, torch.float32):
            ys = [torch.randn((G * S, c), generator=g, device=dev).to(dt)
                  for c in (cp, ck)]
            stats = []
            for y in ys:
                c = y.shape[1]
                yf = y.float()
                stats.append((torch.randn(c, generator=g, device=dev),
                              0.1 * torch.randn(c, generator=g, device=dev),
                              yf.mean(0), yf.var(0, unbiased=False)))
            w = torch.randn((ck, cp), generator=g, device=dev) / cp ** 0.5
            check_bwd_chain(torch, dev, g, "ragged", ys, stats, [w], S,
                            check, errs)
    check_top_first(torch, dev, check)
    torch.cuda.synchronize()


# row 13's first-occurrence checks: cls_ssg SA2's top layer and a ragged
# shape (C not a multiple of the 16-byte vector)
TOP_FIRST = ((2048, 64, 256), (333, 5, 131))


def check_top_first(torch, dev, check: Checks) -> None:
    """Phase 19: row 13 on `first_occurrence_case` inputs, where only the
    first-occurrence argmax passes: T1/T2 within `sum_ok` of the exact sums
    of the plain version's terms, NaN in the same channels."""
    from pointnet2_tpu_torch.ops import fused_mlp as fm

    with torch.no_grad():
        for G, S, C in TOP_FIRST:
            for dt in (torch.bfloat16, torch.float32):
                for nan in (False, True):
                    y, gg, p = (t.to(dev) for t in first_occurrence_case(
                        torch, G, S, C, dt, SEED + 19, nan))
                    t1, t2 = fm.fused_top_stats_kernel(y, gg, p, True)
                    (w1, w2), (a1, a2) = chain_terms(torch, y, gg, p, True)
                    same_nan = (torch.equal(t1.isnan(), w1.isnan())
                                and torch.equal(t2.isnan(), w2.isnan()))
                    fin = ~w2.isnan()
                    ok = sum_ok(t1, w1, a1) and sum_ok(t2[fin], w2[fin],
                                                       a2[fin])
                    check(ok and same_nan,
                          f"fused_top_stats first occurrence {(G, S, C)} "
                          f"{str(dt)[6:]}{' with NaNs' if nan else ''}: "
                          f"T1/T2 within {SUM_RTOL} of sum|terms| of the "
                          f"exact sums {ok}, NaN in the same channels "
                          f"{same_nan} ({int((~fin).sum())} NaN channels)")


def fixed_step(torch, dev, batch: dict, dtype, impl: str, fused: bool,
               double: bool = False) -> tuple:
    """One cls_ssg train-mode forward and backward on the card from the
    seed's weights, with fixed dropout masks and no augmentation (so that
    every route sees the same numbers): (loss, {grad}, {buffer}) in
    float64, after the route's own arithmetic (dtype None: f32; `double`:
    the float64 reference, which never takes the fused chain), and the
    launches of the chain's backward kernels {name: count}."""
    from pointnet2_tpu_torch import config, get_model, ops
    from pointnet2_tpu_torch.models.losses import classification_loss

    model = get_model(CLS_SSG, device="cpu", seed=SEED, dtype=dtype)
    model = model.to(dev).train()
    if double:
        model = model.double()
    B = batch["points"].shape[0]
    keeps = {w: (torch.arange(B * w, device=dev).reshape(B, w) * 7919 % 13
                 < 6) for w in (512, 256)}
    for drop, w in ((model.drop1, 512), (model.drop2, 256)):
        drop.keep_mask = lambda shape, device, generator, k=keeps[w]: k
    pts, mask = batch["points"], batch["mask"]
    if double:
        pts, mask = pts.double(), mask.double()
    before = {k: ops.KERNELS[k].launches for k in BWD}
    with config.default_impl(impl), config.fused_mlp(fused):
        num, den = classification_loss(model(pts, 0.5), batch["label"],
                                       mask, sum_count=True)
        (num / den).backward()
    return (float((num / den).detach()),
            {k: p.grad.double() for k, p in model.named_parameters()},
            {k: b.double() for k, b in model.named_buffers()},
            {k: ops.KERNELS[k].launches - before[k] for k in BWD})


def fused_layers(torch, dev, dtype, impl: str, inputs: list, cots: list,
                 name: str = CLS_SSG, layers=("sa1", "sa2")) -> tuple:
    """A model's SA `layers` from the seed's weights (cls_ssg's SA1 and
    SA2 by default), in train mode with the gate on, each on fixed inputs
    and with one backward of a fixed cotangent of its output: (outputs,
    {grad}, {running statistic}), the latter two in float64."""
    from pointnet2_tpu_torch import config, get_model

    model = get_model(name, device="cpu", seed=SEED, dtype=dtype)
    model = model.to(dev).train()
    outs = []
    with config.default_impl(impl), config.fused_mlp(True):
        for layer, (xyz, pts), cot in zip(layers, inputs, cots):
            out = getattr(model, layer)(xyz, pts)[1]
            (out.float() * cot).sum().backward()
            outs.append(out.detach())
    prefixes = tuple(f"{layer}." for layer in layers)
    return (outs, {k: p.grad.double() for k, p in model.named_parameters()
                   if k.startswith(prefixes)},
            {k: b.double() for k, b in model.named_buffers()
             if k.startswith(prefixes)})


def fused_layer_errs(torch, dev, dtype, points, name: str = CLS_SSG,
                     layers=("sa1", "sa2")) -> dict:
    """A model's fused SA layers (cls_ssg's two by default) through the
    kernels against the same layers through the plain versions, on the
    same inputs (each layer's: the previous layer's plain output) and
    cotangents: the share of output elements that differ, the largest
    output difference over max|out|, the largest gradient difference over
    its norm (dense biases in front of a train-mode BN aside,
    `bn_fed_bias`), and the largest running-statistic difference over its
    tensor's scale. The two routes see the same indices and gathers; they
    part only where the kernels sum in another order (the BN statistics,
    the products, T1/T2), which moves a rounding of an activation or of dy
    now and then."""
    from pointnet2_tpu_torch import config, get_model

    model = get_model(name, device="cpu", seed=SEED, dtype=dtype)
    model = model.to(dev).train()
    inputs, outs = [], []
    xyz, pts = points, None
    with torch.no_grad(), config.default_impl("torch"), config.fused_mlp(
            True):
        for layer in layers:
            inputs.append((xyz, pts))
            xyz, pts, _ = getattr(model, layer)(xyz, pts)
            outs.append(pts)
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    cots = [torch.randn(o.shape, generator=g, device=dev) for o in outs]
    ka, ga, ba = fused_layers(torch, dev, dtype, "auto", inputs, cots, name,
                              layers)
    kb, gb, bb = fused_layers(torch, dev, dtype, "torch", inputs, cots, name,
                              layers)
    return {
        "outputs differ": max(float((a != b).float().mean())
                              for a, b in zip(ka, kb)),
        "output": max(float((a.float() - b.float()).abs().max()
                            / b.float().abs().max()) for a, b in zip(ka, kb)),
        "gradient": max(float((ga[k] - gb[k]).norm() / gb[k].norm())
                        for k in gb if not bn_fed_bias(k)),
        "running statistics": max(float((ba[k] - bb[k]).abs().max()
                                        / bb[k].abs().max()) for k in bb)}


def check_fused_train_step(torch, dev, check: Checks, log_dir: str) -> None:
    """Phase 20a: one full-width cls_ssg train step (B=16, N=1024) with the
    gate on through the kernels, through the plain versions, and unfused
    (kernels and plain), each against a float64 run of the same step. The
    kernels sum in other orders than cuBLAS and PyTorch's reductions, and
    train-mode BN's E[y^2] - E[y]^2 magnifies that, so no two f32 routes
    are equal; each is held to float64 instead, as the CPU tests hold the
    port's step: f32 loss within 1e-5, running statistics within 1e-3 of
    each tensor's scale, each gradient within 2e-2 of its norm (gradients
    whose float64 norm is under 1e-6 of the largest are zero in exact
    arithmetic and not compared). In bf16 no whole step can be held tight:
    every route is ~1.0 from float64 at init (median gradient error) and
    two bf16 routes ~0.3 apart, where the same routes are within 2e-2 a
    layer; those distances are logged, not checked. The bf16 chain is held
    layer by layer instead (`check_fused_layers`, both dtypes), and kernel
    by kernel in phase 19. Then launches of one fused step, and (logged)
    whether two fused steps give the same bits."""
    from pointnet2_tpu_torch import ops

    log("phase 20: one train step with config.fused_mlp(True) on the card: "
        "kernels, plain versions and the unfused route against float64")
    batch = train_batch(torch, dev)
    ref = fixed_step(torch, dev, batch, None, "torch", False, double=True)
    top = max(float(g.norm()) for g in ref[1].values())
    compared = [k for k, g in ref[1].items() if float(g.norm()) >= 1e-6 * top]
    routes = (("fused kernels", "auto", True), ("fused plain", "torch", True),
              ("unfused kernels", "auto", False),
              ("unfused plain", "torch", False))
    for dtype in (None, torch.bfloat16):
        name = "f32" if dtype is None else "bf16"
        grads = {}
        for what, impl, fused in routes:
            loss, grads[what], b, launched = fixed_step(torch, dev, batch,
                                                        dtype, impl, fused)
            want = (bwd_per_step(TRAIN_MODELS[CLS_SSG])
                    if impl == "auto" and fused else {})
            check(launched == {k: want.get(k, 0) for k in BWD},
                  f"{name} {what}: the chain's backward kernels launched "
                  f"{launched}")
            rel = {k: float((grads[what][k] - ref[1][k]).norm()
                            / ref[1][k].norm()) for k in compared}
            stats = max(float((b[k] - ref[2][k]).abs().max()
                              / ref[2][k].abs().max().clamp_min(1e-30))
                        for k in b)
            worst = max(rel, key=rel.get)
            lrel = abs(loss - ref[0]) / ref[0]
            median = statistics.median(rel.values())
            log(f"  {name} {what}: loss {loss:.6f} (float64 {ref[0]:.6f}, "
                f"{lrel:.2e}), running statistics {stats:.2e} of scale, "
                f"gradients median {median:.2e}, worst {rel[worst]:.2e} "
                f"({worst}) of their norm")
            if dtype is None:
                check(lrel <= 1e-5 and stats <= 1e-3 and rel[worst] <= 2e-2,
                      f"f32 {what} vs float64: loss {lrel:.2e} <= 1e-5, "
                      f"statistics {stats:.2e} <= 1e-3, gradients "
                      f"{rel[worst]:.2e} <= 2e-2")
        fk, fp = grads["fused kernels"], grads["fused plain"]
        apart = statistics.median(float((fk[k] - fp[k]).norm()
                                        / fp[k].norm()) for k in compared)
        log(f"  {name} fused kernels vs fused plain: gradients median "
            f"{apart:.2e} of their norm (logged)")
    check_fused_layers(torch, dev, check)
    want = bwd_per_step(TRAIN_MODELS[CLS_SSG])
    with make_trainer(torch, "bfloat16", os.path.join(log_dir, "fused_step"),
                      1) as tr:
        before = {k: w.launches for k, w in ops.KERNELS.items()}
        first = one_step(torch, tr, batch, "auto", fused=True)
        launched = {k: ops.KERNELS[k].launches - before[k] for k in want}
        again = one_step(torch, tr, batch, "auto", fused=True)
    check(launched == want, f"launches in one fused bf16 train step "
          f"{launched}")
    same = first[0] == again[0] and all(
        torch.equal(first[1][k], again[1][k]) for k in first[1])
    log(f"  two fused bf16 kernel-path steps (Trainer, augment on, the same "
        f"generator seed) give bitwise equal loss and gradients: {same}")
    torch.cuda.synchronize()


def check_fused_layers(torch, dev, check: Checks) -> None:
    """Phase 20b: `fused_layer_errs` on each of LAYER_INPUTS, f32 and bf16;
    the worst of them within LAYER_LIMITS."""
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        worst = {}
        for i, (b, n, kind) in enumerate(LAYER_INPUTS):
            if kind == "clouds":
                pts = make_clouds(b, n, SEED + 20 + i)
            else:
                pts = np.random.default_rng(SEED + 20 + i).random(
                    (b, n, 3), dtype=np.float32)
            errs = fused_layer_errs(torch, dev, dtype,
                                    torch.from_numpy(pts).to(dev))
            log(f"  {name} fused layers B={b} N={n} {kind}: " + ", ".join(
                f"{k} {v:.2e}" for k, v in errs.items()))
            worst = {k: max(v, worst.get(k, 0.0)) for k, v in errs.items()}
        check(all(worst[k] <= LAYER_LIMITS[name][k] for k in worst),
              f"{name} cls_ssg SA1 and SA2 in train mode with the gate on, "
              f"kernels vs plain, worst of {len(LAYER_INPUTS)} inputs: "
              + ", ".join(f"{k} {worst[k]:.2e} <= {LAYER_LIMITS[name][k]:g}"
                          for k in worst))


def fused_train_fit(torch, check: Checks, log_dir: str) -> dict:
    """Phase 20c: the fused train path's main-path run, Trainer.fit of
    cls_ssg and cls_msg in bf16 with the gate on, each from the launch
    counters' zero; the loss must fall and every step launch the chain's
    kernels as designed. Returns the launches summed over both."""
    from pointnet2_tpu_torch import config, ops
    from pointnet2_tpu_torch.data import SyntheticClassification

    log(f"phase 20: Trainer.fit with config.fused_mlp(True), N={N_POINT}, "
        f"batch 16, augment='cls', Adam lr 1e-3, bf16, {TRAIN_EPOCHS} "
        "epochs each of cls_ssg and cls_msg")
    datasets = [SyntheticClassification(num_classes=NUM_CLASSES,
                                        samples_per_class=8, npoints=N_POINT,
                                        batch_size=16, seed=s)
                for s in (0, 1)]
    total = dict.fromkeys(ops.KERNELS, 0)
    for name, chains in TRAIN_MODELS.items():
        for w in ops.KERNELS.values():
            w.launches = 0
        run_dir = os.path.join(log_dir, f"fused_fit_{name}")
        t0 = time.perf_counter()
        with config.fused_mlp(True), make_trainer(
                torch, "bfloat16", run_dir, TRAIN_EPOCHS, model=name) as tr:
            state = tr.fit(datasets[0], eval_dataset=datasets[1])
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in ops.KERNELS.items()}
        steps = state.step
        evals = TRAIN_EPOCHS * datasets[1].num_batches()
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses = [r["loss"] for r in rows if r["split"] == "train"]
        accs = [r["accuracy"] for r in rows if r["split"] == "eval"]
        check(len(losses) == TRAIN_EPOCHS and losses[-1] < losses[0]
              and all(np.isfinite(losses)),
              f"{name} fused bf16: train loss by epoch "
              f"{[round(x, 4) for x in losses]} falls (eval accuracy "
              f"{[round(x, 4) for x in accs]}); {steps} steps, "
              f"{time.perf_counter() - t0:.1f} s")
        per = bwd_per_step(chains)
        want = {k: per[k] * steps for k in BWD}
        # the eval forwards take the eval chain: dense and pool launches
        want["fused_dense"] = per["fused_dense"] * (steps + evals)
        want["fused_pool"] = per["fused_pool"] * (steps + evals)
        got = {k: counts[k] for k in want}
        log(f"  launches in {name}'s fused train run ({steps} steps, {evals} "
            f"eval forwards): {counts}")
        check(got == want, f"{name}: per step {per} of the chain's kernels "
              "(and the eval forwards' dense and pool launches)")
        total = {k: total[k] + counts[k] for k in total}
    return total


def bwd_bounds(kind: str, shape: tuple, isz: int) -> tuple:
    """The least time for one launch's work: each input read once and each
    output written once (the dy scratch and the partials are the kernel's
    own, not counted); rows 14's two products at the tensor cores' bf16
    rate or the f32 FMA rate, rows 13 and 15's few f32 operations an
    element at the rate without FMA."""
    if kind == "fused_top_stats":
        G, S, C = shape
        byts = (G * S * C + G * C) * isz + 9 * C * 4
        return roofline(5 * G * S * C, byts)
    if kind == "fused_dense_bwd":
        R, ck, cp, items = shape
        byts = ((R * ck + 2 * R * cp + items * ck) * isz
                + (2 * ck * cp + 8 * ck + 9 * cp) * 4)
        rate = BF16_TENSOR_OPS_PER_S if isz == 2 else F32_FMA_OPS_PER_S
        return roofline(4 * R * ck * cp, byts, rate)
    R, C = shape
    return roofline(10 * R * C, 3 * R * C * isz + 7 * C * 4)


def time_fused_bwd_kernels(torch, dev, gpu: str, chains: list,
                           rows: dict) -> None:
    """Phase 21a: rows 13-15 per launch along cls_ssg's two chains at B=16
    (the table holds bf16: one train step's launches), beside their bounds
    and plain versions; and each chain's backward, fused (the kernels
    through fused_chain_train) against the unfused autograd backward of the
    same SharedMLP in train mode (what the chain stands for), timed
    here only."""
    import copy

    from pointnet2_tpu_torch import config
    from pointnet2_tpu_torch.ops import fused_mlp as fm

    log(f"phase 21: fused backward kernels per launch at a cls_ssg train "
        f"step's shapes, B=16, on {gpu} (kernels with the queue pre-filled, "
        "plain with the host in the loop)")
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    for dt in (torch.bfloat16, torch.float32):
        isz = 2 if dt == torch.bfloat16 else 4
        for tag, mlp, R, ns in chains:
            if not tag.startswith("cls_ssg"):
                continue
            with torch.no_grad():
                ys, stats, ws = saved_chain(torch, dev, g, mlp, R, dt)
                D = len(ys) - 1
                packs = [fm.bn_pack(*st, 1e-3) for st in stats]
                y_top = ys[D].reshape(R // ns, ns, -1)
                gcur = torch.randn((R // ns, y_top.shape[-1]), generator=g,
                                   device=dev).to(dt)
                C = y_top.shape[-1]
                part = fm.top_stats_part(R // ns, C, dev)
                sums = torch.zeros((2, C), device=dev)
                ms = event_ms(torch, lambda: fm.launch_fused_top_stats(
                    y_top, gcur, packs[D], part, sums, ns), 50, prefill=True)
                plain = event_ms(torch, lambda: fm.top_stats_plain(
                    y_top, gcur, packs[D], True), 10)
                emit_bwd(torch, rows, "fused_top_stats",
                         f"{tag} {tuple(y_top.shape)}", dt, ms, plain,
                         bwd_bounds("fused_top_stats", tuple(y_top.shape),
                                    isz))
                for k in range(D, 0, -1):
                    yk = y_top if k == D else ys[k]
                    items, S = (R // ns, ns) if k == D else (R, 1)
                    ck, cp = ws[k - 1].shape
                    bufs = fm.dense_bwd_buffers(yk, cp, S)
                    gk = gcur if k == D else torch.randn(
                        (R, ck), generator=g, device=dev).to(dt)
                    ms = event_ms(torch, lambda: fm.launch_fused_dense_bwd(
                        yk, ys[k - 1], gk, packs[k], packs[k - 1], ws[k - 1],
                        bufs, S), 20, prefill=True)
                    plain = event_ms(torch, lambda: fm.dense_bwd_plain(
                        yk, ys[k - 1], gk, packs[k], packs[k - 1], ws[k - 1],
                        k == D), 5)
                    emit_bwd(torch, rows, "fused_dense_bwd",
                             f"{tag} k={k} ({R},{ck})->({R},{cp})", dt, ms,
                             plain, bwd_bounds("fused_dense_bwd",
                                               (R, ck, cp, items), isz))
                    if dt == torch.bfloat16:  # a yardstick, logged only
                        dyc, w16 = bufs["dyc"], ws[k - 1].to(dt)
                        z = fm.affine_fwd_plain(ys[k - 1], packs[k - 1][0],
                                                packs[k - 1][1])
                        mm = event_ms(torch, lambda: (
                            torch.mm(dyc, w16), torch.mm(dyc.t(), z)), 20,
                            prefill=True)
                        log(f"   fused_dense_bwd {tag} k={k}: the two bare "
                            f"bf16 torch.mm products (g, dW) at its shapes "
                            f"{mm:.6f} ms")
                x, gx = ys[0], torch.randn(ys[0].shape, generator=g,
                                           device=dev).to(dt)
                dx = torch.empty_like(x)
                ms = event_ms(torch, lambda: fm.launch_fused_first_bwd(
                    x, gx, packs[0], dx), 50, prefill=True)
                plain = event_ms(torch, lambda: fm.first_bwd_plain(
                    x, gx, packs[0]), 10)
                emit_bwd(torch, rows, "fused_first_bwd",
                         f"{tag} {tuple(x.shape)}", dt, ms, plain,
                         bwd_bounds("fused_first_bwd", tuple(x.shape), isz))
            # the chain's whole backward, fused against unfused autograd,
            # on a copy of the layer (train-mode forwards move its BN
            # statistics)
            layer = copy.deepcopy(mlp).train()
            for m in layer.modules():  # compute in dt, as a dt model does
                if hasattr(m, "dtype"):
                    m.dtype = dt
            x4 = ys[0].reshape(16, R // ns // 16, ns, -1).detach()
            x4.requires_grad_()
            params = list(layer.parameters())
            times = {}
            for route in ("unfused", "fused"):
                with config.fused_mlp(route == "fused"):
                    if route == "fused":
                        out = layer.fused_tail(x4)
                    else:
                        out = layer.finish_first_pooled(x4, dim=2)
                go = torch.randn(out.shape, generator=g, device=dev).to(dt)
                times[route] = event_ms(torch, lambda: torch.autograd.grad(
                    out, [x4, *params], go, retain_graph=True,
                    allow_unused=True), 10)
            log(f"   {tag} {str(dt)[6:]}: the chain's backward, fused "
                f"{times['fused']:.6f} ms, unfused autograd "
                f"{times['unfused']:.6f} ms "
                f"({times['fused'] / times['unfused']:.2f}x)")


def emit_bwd(torch, rows: dict, name: str, shape: str, dt, ms, plain,
             bound) -> None:
    """bf16 times go into the table (one train step's launches), f32 ones
    into the log only."""
    if dt == torch.bfloat16:
        add_time(rows, name, f"{shape} bf16", ms, plain, bound)
    else:
        log(f"  {name:<12} {shape + ' f32':<44} kernel {ms:.6f} ms  plain "
            f"{plain:.6f} ms  bound {bound[0]:.6f} ms ({bound[1]})")
    log(f"   {name} {shape}: {bound[0] / ms:.1%} of the {bound[1]} roofline")


def time_fused_train(torch, dev, gpu: str, log_dir: str) -> None:
    """Phase 21b: the train step fused against unfused, cls_ssg and cls_msg
    at B=16 in bf16 and f32: host ms (median of 10), examples/s, device
    time (torch.profiler busy us a step), peak device memory; then where a
    fused bf16 cls_ssg step's device time goes."""
    from pointnet2_tpu_torch import config
    from pointnet2_tpu_torch.train.steps import run_one_step

    log(f"phase 21: train steps fused vs unfused at B=16, N={N_POINT} (host "
        f"clock; device time by torch.profiler) on {gpu}")
    batch = train_batch(torch, dev)
    host = {}
    for name in TRAIN_MODELS:
        for dtype in ("bfloat16", "float32"):
            with make_trainer(torch, dtype, os.path.join(log_dir, "ftime"),
                              1, model=name) as tr:
                state = tr.init_state()

                def step():
                    run_one_step(state, batch, tr.loss_fn, tr.bn_schedule,
                                 tr.augment_fn, tr.generator)

                line = []
                for route in ("unfused", "fused"):
                    with config.fused_mlp(route == "fused"):
                        ms = host[name, dtype, route] = host_ms(
                            torch, step, 10, warmup=2)
                        kernels, _, _, _ = trace_device(torch, step, 2)
                        torch.cuda.reset_peak_memory_stats()
                        step()
                        torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated() / 2 ** 30
                    busy = sum(r[0] for r in kernels)
                    line.append(f"{route} {ms:.3f} ms/step "
                                f"({16 / ms * 1e3:.1f} examples/s), {busy:.1f}"
                                f" us device, peak {peak:.2f} GiB")
                log(f"  {name} {dtype}: " + "; ".join(line))
                if name == CLS_SSG and dtype == "bfloat16":
                    with config.fused_mlp(True):
                        profile_device(
                            torch, step, 3, f"{name} fused bf16 train step",
                            "step", host_us=host[name, dtype, "fused"] * 1e3)


# --- segmentation training --------------------------------------------------

# each segmentation model's training: points a cloud, the on-device
# augmentation (ScanNet: rotation about z; ShapeNet-part: none, as the
# reference's part_seg/train.py), per-forward launches of its main path
SEG_TRAIN = {SEM: {"n": SEM_N, "augment": "scannet",
                   "per_fwd": SEG_PER_FWD[SEM]},
             PART: {"n": PART_N, "augment": "none",
                    "per_fwd": SEG_PER_FWD[PART]},
             PART_MSG: {"n": PART_N, "augment": "none",
                        "per_fwd": MSG_PER_FWD[PART_MSG]}}
SEG_EPOCHS = 4  # per run of phase 23
SEG_TRAIN_SCENES, SEG_EVAL_SCENES = 48, 16  # generated rooms: 3 + 1 batches


def seg_trainer(torch, name: str, dtype: str, log_dir: str, epochs: int):
    return make_trainer(torch, dtype, log_dir, epochs, model=name,
                        num_point=SEG_TRAIN[name]["n"],
                        augment=SEG_TRAIN[name]["augment"])


def seg_datasets(name: str) -> tuple:
    """(train, eval) data of a model: ScannetDataset crops of generated
    rooms (8192 points, the wdp input dropout on the train split) for
    sem_seg, SyntheticShapeNetPart (2048 points with normals, category
    labels) for the part segmenters; batches of 16."""
    from pointnet2_tpu_torch.data import (
        ScannetDataset,
        SyntheticShapeNetPart,
        make_synthetic_scenes,
    )

    if name == SEM:
        return tuple(ScannetDataset(
            scenes=make_synthetic_scenes(k, 20000, seed=SEED + 20 + i),
            npoints=SEM_N, split=split, batch_size=16, seed=SEED + i)
            for i, (k, split) in enumerate(((SEG_TRAIN_SCENES, "train"),
                                            (SEG_EVAL_SCENES, "test"))))
    return tuple(SyntheticShapeNetPart(num_samples=k, npoints=PART_N,
                                       batch_size=16, seed=SEED + i)
                 for i, k in enumerate((SEG_TRAIN_SCENES, SEG_EVAL_SCENES)))


# phase 22's bounds on a gradient's kernel-vs-plain difference (of its
# scale, grad_differences): f32, the scatter's summation order; bf16, the
# same order's last bf16 bits, which the deep train-mode BN backward chains
# amplify (measured up to 0.28 on sem_seg's first dense, 2.5e-2 on
# part_seg): a bound that a zeroed or sign-flipped gradient (1 or more)
# fails, and the median tensor's within 2e-2 (measured 3-6.4e-3). The
# scatter itself is held bit for bit on the step's own cotangents
# (capture_scatters), so the loose bf16 bound covers only what the model
# does with the scatter's last bits.
SEG_STEP_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.5, 2e-2)}
# sem_seg's step with the gate on, kernels against plain versions (the
# fused forward sums in another order, so no two routes share bits): f32
# as phase 20 holds each f32 route against float64 (loss 1e-5 relative,
# running statistics 1e-3 of a tensor's scale, every gradient 2e-2 of its
# scale); bf16 loss 1e-2 and statistics 5e-2 (measured 9.2e-4 and
# 9.3e-3), the gradients logged, not bounded: as phase 20 found for
# cls_ssg, two bf16 routes of a whole step at init lie ~0.3 apart (sem_seg:
# median 0.29, largest 0.51), where the same layers are within LAYER_LIMITS
# of each other, which `check_fused_seg_step` holds on sem_seg's four SA
# layers at the step's shapes
SEG_FUSED_TOL = {"float32": (1e-5, 1e-3, 2e-2), "bfloat16": (1e-2, 5e-2,
                                                             None)}


def exact_zero_biases(model) -> set:
    """The biases whose gradient is zero in exact arithmetic, so that what
    either path computes is the residue of cancelling sums: a dense bias in
    front of a train-mode BN (BN subtracts the batch mean), and the top BN
    bias of a max-pooled SA MLP whose channels' ReLUs pass at every pooled
    maximum (every path from the pool to the loss shifts by the same
    amount: the next layers' gathers, the interpolations with weights that
    sum to 1, then a dense and a train-mode BN, which subtracts the
    shift)."""
    from pointnet2_tpu_torch.nn import SetAbstraction, SetAbstractionMSG

    tops = set()
    for mod in model.modules():
        if isinstance(mod, SetAbstraction) and mod.pooling == "max":
            tops.add(id(mod.mlp_mod.blocks[-1]))
        elif isinstance(mod, SetAbstractionMSG):
            tops.update(id(m.blocks[-1]) for m in mod.mlp_mods)
    names = set()
    for name, mod in model.named_modules():
        if getattr(mod, "norm", None) is not None and hasattr(mod, "dense"):
            names.add(f"{name}.dense.bias")
        if id(mod) in tops:
            names.add(f"{name}.norm.bias")
    return names


def grad_differences(torch, ga: dict, gb: dict, zero: set) -> list:
    """(|ga - gb| over its scale, name) of every gradient, largest first.
    A tensor's scale is its norm in `gb`; for a bias in `zero`
    (`exact_zero_biases`) the larger of that and its layer's weight's,
    since the residue both paths compute is of the size of the terms that
    cancel, which the weight's gradient shows."""
    out = []
    for k in ga:
        scale = gb[k].float().norm()
        if k in zero:
            w = gb[k[:-len("bias")] + "weight"]
            scale = torch.maximum(scale, w.float().norm())
        out.append((float((ga[k] - gb[k]).float().norm()
                          / scale.clamp_min(1e-30)), k))
    return sorted(out, reverse=True)


class capture_scatters:
    """Within the block, every scatter kernel launch also records copies
    of its inputs and output (g, idx, out), in launch order."""

    def __enter__(self):
        from pointnet2_tpu_torch.ops import grouping

        self.calls, self.launch = [], grouping.launch_scatter_rows

        def record(g, idx, out, bufs):
            self.launch(g, idx, out, bufs)
            self.calls.append((g.clone(), idx.clone(), out.clone()))

        grouping.launch_scatter_rows = record
        return self.calls

    def __exit__(self, *exc):
        from pointnet2_tpu_torch.ops import grouping

        grouping.launch_scatter_rows = self.launch


def check_step_scatters(torch, tag: str, calls: list, check: Checks) -> None:
    """Phase 22: each scatter a train step launched, bit for bit its plain
    version on CPU copies of the same cotangent rows and indices."""
    same = [scatter_same(torch, out, g, idx, out.shape[1])
            for g, idx, out in calls]
    shapes = sorted({(tuple(g.shape), out.shape[1]) for g, _, out in calls})
    check(len(calls) > 0 and all(ok for ok, _ in same),
          f"{tag}: the step's {len(calls)} scatters, bit for bit the plain "
          f"version on CPU copies {sum(ok for ok, _ in same)}/{len(calls)} "
          f"(max abs diff {max((e for _, e in same), default=0.0):.3e}); "
          f"g -> n {shapes}")


def check_seg_train_step(torch, dev, check: Checks, log_dir: str) -> dict:
    """Phase 22: one full-width train step of each segmentation model
    (B=16; sem_seg on a ScanNet crop of 8192 points with its wdp-zeroed
    weights and the z rotation, the part segmenters on 2048 points with
    normals, part_seg_msg with its category labels) through the kernels and
    through the plain versions on the card, from the same weights, batch
    and generator seed, f32 and bf16. The forward is the same bits
    (identical indices, exact gathers), so the loss and the running
    statistics must be equal; gradients differ only by the scatter's
    summation order (atomic index_add_ in the plain path): SEG_STEP_TOL of
    their scales (grad_differences), and every scatter of the kernel path's
    step is bit for bit its plain version on CPU copies of its inputs.
    Then sem_seg with the gate on (`check_fused_seg_step`). Returns the
    host batches."""
    log("phase 22: one segmentation train step per model, kernel path vs "
        "plain path on the card")
    batches = {}
    for name in SEG_TRAIN:
        batches[name] = next(seg_datasets(name)[0].epoch())
        for dtype, (tol, median_tol) in SEG_STEP_TOL.items():
            t0 = time.perf_counter()
            with seg_trainer(torch, name, dtype, os.path.join(
                    log_dir, "seg_step"), 1) as tr:
                batch = tr._to_device(batches[name])
                zero = exact_zero_biases(tr.init_state().model)
                with capture_scatters() as calls:
                    la, ga, ba, _ = one_step(torch, tr, batch, "auto")
                lb, gb, bb, _ = one_step(torch, tr, batch, "torch")
            stats_equal = all(torch.equal(ba[k], bb[k]) for k in ba)
            diffs = grad_differences(torch, ga, gb, zero)
            median = float(np.median([d for d, _ in diffs]))
            finite = all(bool(torch.isfinite(g).all()) for g in ga.values())
            check(la == lb and np.isfinite(la) and stats_equal and finite
                  and diffs[0][0] <= tol and median <= median_tol,
                  f"{name} {dtype}: loss {la:.6f} (plain {lb:.6f}), running "
                  f"statistics equal: {stats_equal}, gradient differences "
                  f"of {len(diffs)} tensors: largest {diffs[0][0]:.2e} "
                  f"({diffs[0][1]}), next {diffs[1][0]:.2e} ({diffs[1][1]}),"
                  f" median {median:.2e}; bounds {tol:g}, median "
                  f"{median_tol:g}; {time.perf_counter() - t0:.1f} s")
            check_step_scatters(torch, f"{name} {dtype}", calls, check)
            del calls
    check_fused_seg_step(torch, check, log_dir, batches[SEM])
    torch.cuda.synchronize()
    return batches


def check_fused_seg_step(torch, check: Checks, log_dir: str,
                         host_batch: dict) -> None:
    """Phase 22b: sem_seg's train step with config.fused_mlp on, through
    the kernels and through the plain versions on the card, f32 and bf16,
    within SEG_FUSED_TOL; the kernel path launches the fused chain's
    kernels for each of the four SA layers and the plain path none; then
    sem_seg's four SA layers on the step's crop, kernels against plain
    versions (`fused_layer_errs`), within LAYER_LIMITS."""
    from pointnet2_tpu_torch import ops

    want = bwd_per_step(4)
    for dtype, (ltol, stol, tol) in SEG_FUSED_TOL.items():
        with seg_trainer(torch, SEM, dtype, os.path.join(
                log_dir, "seg_step"), 1) as tr:
            batch = tr._to_device(host_batch)
            zero = exact_zero_biases(tr.init_state().model)
            launched = {}
            for impl in ("auto", "torch"):
                before = {k: ops.KERNELS[k].launches for k in want}
                launched[impl] = (one_step(torch, tr, batch, impl,
                                           fused=True),
                                  {k: ops.KERNELS[k].launches - before[k]
                                   for k in want})
        (la, ga, ba, _), got = launched["auto"]
        (lb, gb, bb, _), none = launched["torch"]
        lrel = abs(la - lb) / abs(lb)
        stats = max(float((ba[k] - bb[k]).abs().max()
                          / bb[k].abs().max().clamp_min(1e-30)) for k in bb)
        diffs = grad_differences(torch, ga, gb, zero)
        median = float(np.median([d for d, _ in diffs]))
        finite = all(bool(torch.isfinite(g).all()) for g in ga.values())
        check(finite and lrel <= ltol and stats <= stol
              and (tol is None or diffs[0][0] <= tol)
              and got == want and not any(none.values()),
              f"{SEM} {dtype} fused: loss {la:.6f} (plain {lb:.6f}, "
              f"{lrel:.2e} <= {ltol:g}), running statistics {stats:.2e} <= "
              f"{stol:g} of scale, gradient differences of {len(diffs)} "
              f"tensors: largest {diffs[0][0]:.2e} ({diffs[0][1]})"
              f"{' (logged)' if tol is None else f' <= {tol:g}'}, median "
              f"{median:.2e}; launches {got}, plain {none}")
    xyz = torch.from_numpy(np.ascontiguousarray(
        host_batch["points"][..., :3])).to(batch["points"].device)
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        errs = fused_layer_errs(torch, xyz.device, dtype, xyz, SEM,
                                ("sa1", "sa2", "sa3", "sa4"))
        limits = LAYER_LIMITS[name]
        check(all(errs[k] <= limits[k] for k in errs),
              f"{name} sem_seg SA1-SA4 in train mode with the gate on, "
              f"kernels vs plain on the step's crop (B=16, 8192 points): "
              + ", ".join(f"{k} {errs[k]:.2e} <= {limits[k]:g}"
                          for k in errs))


def seg_train_fit(torch, check: Checks, log_dir: str) -> dict:
    """Phase 23: the segmentation training main path, Trainer.fit of each
    model in bf16 and f32 and of sem_seg in bf16 with config.fused_mlp on,
    from the launch counters' zero: the train loss must fall, the eval's
    per-point accuracy be logged, and each forward launch its path's FPS,
    ball query and three-NN kernels. Returns the launches summed over the
    runs."""
    from pointnet2_tpu_torch import config, ops

    log(f"phase 23: Trainer.fit of {', '.join(SEG_TRAIN)}, batch 16, Adam "
        f"lr 1e-3, {SEG_EPOCHS} epochs each in bf16 and f32 (sem_seg bf16 "
        "also with config.fused_mlp on)")
    runs = [(name, dtype, False) for name in SEG_TRAIN
            for dtype in ("bfloat16", "float32")] + [(SEM, "bfloat16", True)]
    total = dict.fromkeys(ops.KERNELS, 0)
    data = {name: seg_datasets(name) for name in SEG_TRAIN}
    for name, dtype, fused in runs:
        train, evals = data[name]
        for w in ops.KERNELS.values():
            w.launches = 0
        tag = f"{name} {dtype}{' fused' if fused else ''}"
        run_dir = os.path.join(log_dir, f"seg_fit_{name}_{dtype}_{fused}")
        t0 = time.perf_counter()
        with config.fused_mlp(fused), seg_trainer(torch, name, dtype, run_dir,
                                                  SEG_EPOCHS) as tr:
            state = tr.fit(train, eval_dataset=evals)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in ops.KERNELS.items()}
        steps = state.step
        fwds = steps + SEG_EPOCHS * evals.num_batches()
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses = [r["loss"] for r in rows if r["split"] == "train"]
        accs = [r["accuracy"] for r in rows if r["split"] == "eval"]
        check(len(losses) == SEG_EPOCHS and all(np.isfinite(losses))
              and losses[-1] < losses[0] and len(accs) == SEG_EPOCHS
              and all(0.0 <= a <= 1.0 for a in accs),
              f"{tag}: train loss by epoch {[round(x, 4) for x in losses]} "
              f"falls, eval per-point accuracy {[round(x, 4) for x in accs]};"
              f" {steps} steps, {time.perf_counter() - t0:.1f} s")
        per = SEG_TRAIN[name]["per_fwd"]
        want = {k: per[k] * fwds for k in ("fps", "ball_query", "three_nn")}
        got = {k: counts[k] for k in want}
        log(f"  launches in the {tag} run ({steps} steps, {fwds} forwards): "
            f"{counts}")
        check(got == want and counts["scatter_rows"] >= steps
              and counts["gather_rows"] > 0
              and (not fused or all(counts[k] > 0 for k in (
                  "fused_dense", "fused_pool", *BWD))),
              f"{tag}: fps, ball_query and three_nn launched "
              f"{ {k: per[k] for k in want} } times a forward, the scatter "
              "at least once a step"
              + (", every fused-chain kernel" if fused else ""))
        total = {k: total[k] + counts[k] for k in total}
    return total


def time_seg_train(torch, dev, gpu: str, log_dir: str, batches: dict) -> None:
    """Phase 24: the segmentation train steps at B=16 in bf16 and f32 (and
    sem_seg bf16 with config.fused_mlp on and off): ms/step (host clock,
    median of 10), examples/s, device us/step (torch.profiler busy time),
    the card's idle share of the unprofiled step, peak device memory; then
    where a bf16 sem_seg step's device time goes."""
    from pointnet2_tpu_torch import config
    from pointnet2_tpu_torch.train.steps import run_one_step

    log(f"phase 24: segmentation train steps at B=16 (host clock; device "
        f"time by torch.profiler) on {gpu}")
    for name in SEG_TRAIN:
        for dtype in ("bfloat16", "float32"):
            routes = ((False, True) if name == SEM and dtype == "bfloat16"
                      else (False,))
            host = {}
            with seg_trainer(torch, name, dtype, os.path.join(
                    log_dir, "seg_time"), 1) as tr:
                state = tr.init_state()
                batch = tr._to_device(batches[name])

                def step():
                    run_one_step(state, batch, tr.loss_fn, tr.bn_schedule,
                                 tr.augment_fn, tr.generator, tr.task)

                for fused in routes:
                    with config.fused_mlp(fused):
                        ms = host[fused] = host_ms(torch, step, 10, warmup=2)
                        kernels, _, _, _ = trace_device(torch, step, 2)
                        torch.cuda.reset_peak_memory_stats()
                        step()
                        torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated() / 2 ** 30
                    busy = sum(r[0] for r in kernels)
                    log(f"  {name} {dtype}{' fused' if fused else ''}: "
                        f"{ms:.3f} ms/step ({16 / ms * 1e3:.1f} examples/s), "
                        f"{busy:.1f} us device/step, idle "
                        f"{1 - busy / (ms * 1e3):.1%} of the step, peak "
                        f"{peak:.2f} GiB")
                if name == SEM and dtype == "bfloat16":
                    profile_device(torch, step, 2, f"{name} bf16 train step",
                                   "step", host_us=host[False] * 1e3)


# --- checkpoints, the evaluation protocols and the CLIs ----------------------

RESUME_EPOCHS = (2, 4)  # phase 25: stop after the first, resume to the second
# phase 25's runs: (compute dtype, config.fused_mlp)
RESUME_RUNS = (("float32", False), ("bfloat16", True))
PROTOCOL_VOTES = 12
PROTOCOL_ROOMS = 4  # phase 26's generated rooms (at least two)


def resume_data() -> tuple:
    """Phase 25's (train, eval) data: 80 and 40 synthetic clouds of 1024
    points, 5 and 3 batches of 16."""
    from pointnet2_tpu_torch.data import SyntheticClassification

    return tuple(SyntheticClassification(num_classes=NUM_CLASSES,
                                         samples_per_class=k,
                                         npoints=N_POINT, batch_size=16,
                                         seed=s)
                 for s, k in ((0, 2), (1, 1)))


def train_snapshot(torch, tr, state) -> dict:
    """Every tensor a resume must give back: parameters, BN running
    statistics, optimizer moments, and the count, step and generator."""
    opt = state.optimizer.state_dict()
    out = {f"param {k}": v.detach().clone()
           for k, v in state.model.named_parameters()}
    out.update({f"buffer {k}": v.clone()
                for k, v in state.model.named_buffers()})
    for k in state.optimizer.MOMENTS:
        out.update({f"{k} {i}": t.clone() for i, t in enumerate(opt[k])})
    out["count, step"] = torch.tensor([opt["count"], state.step])
    out["generator"] = tr.generator.get_state()
    return out


def snapshot_diff(torch, a: dict, b: dict) -> tuple:
    """(max abs difference over every tensor, names of the tensors that
    differ)."""
    worst, names = 0.0, []
    for k in a:
        if not torch.equal(a[k], b[k]):
            names.append(k)
            worst = max(worst, float((a[k].double() - b[k].double())
                                     .abs().max()))
    return worst, names


def resume_verdict(torch, got: dict, refs: list) -> tuple:
    """(ok, what): a resumed run's snapshot against two uninterrupted runs'.
    Equal bit for bit when the two runs are; else within their spread, in
    no tensor they do not differ in."""
    spread, spread_names = snapshot_diff(torch, refs[0], refs[1])
    err, names = snapshot_diff(torch, got, refs[0])
    if not spread_names:
        return not names, (
            f"equal bit for bit, as the two uninterrupted runs are ({len(got)}"
            " tensors: parameters, BN statistics, optimizer moments, count, "
            f"step, generator); differing: {names[:4]}")
    return err <= spread and set(names) <= set(spread_names), (
        f"the two uninterrupted runs differ (max {spread:.3e} in "
        f"{len(spread_names)} tensors, first {spread_names[:3]}); the resume "
        f"by {err:.3e} in {len(names)} tensors")


def check_resume(torch, check: Checks, log_dir: str) -> dict:
    """Phase 25: Trainer.fit of cls_ssg (B=16, N=1024, augment "cls",
    dropout on) stopped after 2 epochs and resumed to 4 by a new Trainer on
    the same log_dir, in f32 and in bf16 with config.fused_mlp on, against
    two uninterrupted 4-epoch runs from the same seed (the data sets made
    anew for each run and carried across the stop). The resume must equal
    the uninterrupted run bit for bit, or, if the two uninterrupted runs
    differ, stay within their spread and name the tensors. The best
    checkpoint survives a worse first eval after the resume;
    Predictor.from_checkpoint gives the trainer's eval logits; save and
    restore times and the checkpoint's size are logged. Returns the launch
    counts of the resumed runs."""
    from pointnet2_tpu_torch import Predictor, config, ops
    from pointnet2_tpu_torch.train import checkpoint as ckpt

    first, last = RESUME_EPOCHS
    log(f"phase 25: checkpoints and exact resume: Trainer.fit cls_ssg "
        f"N={N_POINT}, batch 16, augment='cls', {first} epochs, stop, resume "
        f"to {last}, against uninterrupted runs")
    total = dict.fromkeys(ops.KERNELS, 0)
    for dtype, fused in RESUME_RUNS:
        tag = f"{dtype}{' fused' if fused else ''}"
        with config.fused_mlp(fused):
            refs = []
            for r in range(2):
                train, evals = resume_data()
                with make_trainer(torch, dtype, os.path.join(
                        log_dir, f"resume_ref{r}_{dtype}"), last) as tr:
                    refs.append(train_snapshot(
                        torch, tr, tr.fit(train, eval_dataset=evals)))
            run_dir = os.path.join(log_dir, f"resume_{dtype}")
            train, evals = resume_data()
            for w in ops.KERNELS.values():
                w.launches = 0
            with make_trainer(torch, dtype, run_dir, last) as tr:
                tr.fit(train, eval_dataset=evals, max_epoch=first)
            # an unbeatable best from before the stop: the resumed run's
            # evals must not overwrite it
            best_meta = ckpt.load_meta(run_dir, "best")
            best_meta["score"] = 2.0
            with open(os.path.join(run_dir, "best.meta.json"), "w") as f:
                json.dump(best_meta, f)
            best_file = os.path.join(run_dir, "best", "state.pt")
            best_bytes = open(best_file, "rb").read()
            with make_trainer(torch, dtype, run_dir, last) as tr:
                state = tr.fit(train, eval_dataset=evals)
                got = train_snapshot(torch, tr, state)
                batch = {"points": next(iter(evals.epoch()))["points"]}
                eval_logits = tr.eval_logits_fn(state)(batch)
                served = Predictor.from_checkpoint(
                    CLS_SSG, run_dir, num_point=N_POINT,
                    dtype=getattr(torch, dtype))(batch["points"])
            torch.cuda.synchronize()
            counts = {k: w.launches for k, w in ops.KERNELS.items()}
        ok, what = resume_verdict(torch, got, refs)
        check(ok, f"{tag}: {first} + {last - first} epochs with a resume "
              f"against {last} uninterrupted: {what}")
        meta = ckpt.load_meta(run_dir, "best")
        check(meta["score"] == 2.0
              and open(best_file, "rb").read() == best_bytes
              and ckpt.load_meta(run_dir) == {"step": int(state.step),
                                              "epoch": last},
              f"{tag}: the best checkpoint (score 2.0 before the stop) "
              f"survives the resumed evals; ckpt at step {state.step}, "
              f"epoch {last}")
        check(served.shape == (len(batch["points"]), NUM_CLASSES)
              and np.array_equal(served, eval_logits),
              f"{tag}: Predictor.from_checkpoint's logits equal the "
              "trainer's eval-mode model's on one batch of 16 (max abs diff "
              f"{float(np.abs(served - eval_logits).max()):.3e})")
        # both halves, the eval-logits forward and the served one
        per = FUSED_PER_FWD[CLS_SSG] if fused else {
            "fps": 2, "ball_query": 2, "gather_rows": 4}
        steps = last * train.num_batches()
        fwds = steps + last * evals.num_batches() + 2
        log(f"  launches in the {tag} run stopped and resumed ({steps} "
            f"steps, {fwds} forwards): {counts}")
        check(all(counts[k] == per[k] * fwds for k in ("fps", "ball_query"))
              and counts["scatter_rows"] == 2 * steps
              and (not fused or all(counts[k] > 0 for k in (
                  "fused_dense", "fused_pool", *BWD))),
              f"{tag}: the resumed run launched fps and ball_query twice a "
              "forward, the scatter twice a step"
              + (", every fused-chain kernel" if fused else ""))
        total = {k: total[k] + counts[k] for k in total}
        time_checkpoint(torch, tag, state, run_dir)
    return total


def time_checkpoint(torch, tag: str, state, run_dir: str) -> None:
    """Save and restore times of a cls_ssg checkpoint (host clock, median of
    5, the restore onto the card) and its size."""
    from pointnet2_tpu_torch.train import checkpoint as ckpt

    gen = torch.Generator(device=next(state.model.parameters()).device)
    save = host_ms(torch, lambda: ckpt.save_checkpoint(
        run_dir, state, name="timed", generator=gen), 5, warmup=1)
    restore = host_ms(torch, lambda: ckpt.restore_checkpoint(
        run_dir, state, name="timed", generator=gen), 5, warmup=1)
    mib = os.path.getsize(os.path.join(run_dir, "timed", "state.pt")) / 2**20
    log(f"  {tag}: checkpoint save {save:.3f} ms, restore {restore:.3f} ms, "
        f"{mib:.3f} MiB (parameters, BN statistics, Adam's two moments)")


def labelled_room(seed: int) -> tuple:
    """A generated room of phase 11's size (100000 points) with spatially
    coherent labels: the nearest of 20 anchors (1-20), about 10%
    unannotated (0)."""
    pts = make_room(100_000, seed)
    rng = np.random.default_rng(seed + 1)
    anchors = rng.uniform(pts.min(0), pts.max(0), (20, 3))
    d = ((pts[:, None, :] - anchors[None]) ** 2).sum(-1)
    labels = (d.argmin(1) + 1).astype(np.int32)
    labels[rng.random(len(pts)) < 0.1] = 0
    return pts, labels


class ProtocolClock:
    """Wall time of a protocol split into its forwards (inside the logits
    function: upload, model, logits back), its metric code (the metric
    class's ``update``) and the rest (views, batching, data)."""

    def __init__(self, fn, metrics_cls=None):
        self.fn, self.metrics_cls = fn, metrics_cls
        self.forward_s = self.metric_s = 0.0
        self.calls = 0

    def logits(self, batch):
        t0 = time.perf_counter()
        out = self.fn(batch)
        self.forward_s += time.perf_counter() - t0
        self.calls += 1
        return out

    def run(self, protocol):
        update = self.metrics_cls.update if self.metrics_cls else None

        def timed(metrics, *a, **k):
            t0 = time.perf_counter()
            update(metrics, *a, **k)
            self.metric_s += time.perf_counter() - t0

        if update is not None:
            self.metrics_cls.update = timed
        t0 = time.perf_counter()
        try:
            result = protocol(self.logits)
        finally:
            if update is not None:
                self.metrics_cls.update = update
        self.wall_s = time.perf_counter() - t0
        return result


def protocol_trainer(torch, name: str, dtype: str, log_dir: str):
    """A Trainer of `name` on the card whose state carries the seeded
    random weights of `random_state_dict`."""
    from pointnet2_tpu_torch.train import TrainConfig, Trainer

    n = {CLS_SSG: N_POINT, SEM: SEM_N, PART: PART_N}[name]
    tr = Trainer(TrainConfig(model=name, num_point=n, batch_size=16,
                             compute_dtype=dtype, log_dir=log_dir),
                 device="cuda")
    state = tr.init_state()
    state.model.load_state_dict(random_state_dict(torch, SEED, name))
    return tr, state


def equal_metrics(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal_metrics(a[k], b[k])
                                            for k in a)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def check_protocols(torch, check: Checks, log_dir: str) -> dict:
    """Phase 26: the four evaluation protocols on the card through
    Trainer.eval_logits_fn on seeded weights: evaluate_cls_voting (cls_ssg,
    12 votes, 80 clouds of 1024 points, B=16), evaluate_part_seg_voting
    (part_seg, 12 votes, 32 synthetic part clouds of 2048 points with
    normals, B=16), evaluate_scannet_chopped and ..._whole_scene (sem_seg,
    8192 points, B=16, on generated rooms of 100000 points). Each runs
    through the kernels (every launch counter from 0, each forward
    launching its path's kernels) and under config.default_impl("torch") on
    the card (no launch): the f32 metric dicts must be equal; bf16 through
    the kernels is logged beside. Logs wall time, inputs/s and the shares
    of forwards and metric code. Returns the launches of the kernel runs."""
    from pointnet2_tpu_torch import config, evaluation, ops
    from pointnet2_tpu_torch.data import (
        ScannetDataset,
        ScannetDatasetWholeScene,
        SyntheticClassification,
        SyntheticShapeNetPart,
    )

    quiet = dict(log_fn=lambda s: None)
    t0 = time.perf_counter()
    rooms = [labelled_room(SEED + 40 + i) for i in range(PROTOCOL_ROOMS)]
    log(f"phase 26: the evaluation protocols on the card, kernels against "
        f"plain versions ({PROTOCOL_ROOMS} generated rooms of 100000 points "
        f"in {time.perf_counter() - t0:.2f} s)")

    def cls_data():
        return SyntheticClassification(num_classes=NUM_CLASSES,
                                       samples_per_class=2, npoints=N_POINT,
                                       batch_size=16, seed=SEED + 3)

    def part_data():
        return SyntheticShapeNetPart(num_samples=32, npoints=PART_N,
                                     batch_size=16, seed=SEED + 3)

    def sem_data(cls):
        return cls(scenes=rooms, npoints=SEM_N, split="test", batch_size=16,
                   seed=SEED + 3)

    # (name, model, its launches a forward, metric class, inputs, protocol)
    runs = [
        ("evaluate_cls_voting", CLS_SSG,
         {"fps": 2, "ball_query": 2, "gather_rows": 4}, None, "clouds",
         lambda fn: evaluation.evaluate_cls_voting(
             lambda p: fn({"points": p}), cls_data(),
             num_votes=PROTOCOL_VOTES, rng=0, **quiet), 80),
        ("evaluate_part_seg_voting", PART, SEG_PER_FWD[PART],
         evaluation.PartSegMetrics, "shapes",
         lambda fn: evaluation.evaluate_part_seg_voting(
             fn, part_data(), num_votes=PROTOCOL_VOTES, rng=0, **quiet), 32),
        ("evaluate_scannet_chopped", SEM, SEG_PER_FWD[SEM],
         evaluation.ScanNetMetrics, "crops",
         lambda fn: evaluation.evaluate_scannet_chopped(
             fn, sem_data(ScannetDataset), rng=0, **quiet), PROTOCOL_ROOMS),
        ("evaluate_scannet_whole_scene", SEM, SEG_PER_FWD[SEM],
         evaluation.ScanNetMetrics, "blocks",
         lambda fn: evaluation.evaluate_scannet_whole_scene(
             fn, sem_data(ScannetDatasetWholeScene), batch_size=16, **quiet),
         None),
    ]
    total = dict.fromkeys(ops.KERNELS, 0)
    for label, name, per, metrics_cls, unit, protocol, n_inputs in runs:
        results = {}
        for route, dtype, impl in (("kernels", "float32", "auto"),
                                   ("plain", "float32", "torch"),
                                   ("kernels", "bfloat16", "auto")):
            tr, state = protocol_trainer(torch, name, dtype, os.path.join(
                log_dir, f"protocol_{name}"))
            for w in ops.KERNELS.values():
                w.launches = 0
            clock = ProtocolClock(tr.eval_logits_fn(state), metrics_cls)
            with tr, config.default_impl(impl):
                res = clock.run(protocol)
            torch.cuda.synchronize()
            counts = {k: w.launches for k, w in ops.KERNELS.items()}
            results[route, dtype] = res
            inputs = n_inputs
            if inputs is None:  # the whole-scene blocks
                inputs = sum(1 for _ in sem_data(
                    ScannetDatasetWholeScene).blocks())
            wall = clock.wall_s
            other = wall - clock.forward_s - clock.metric_s
            log(f"  {label} {route} {dtype}: {wall * 1e3:.1f} ms, "
                f"{inputs / wall:.2f} {unit}/s, {clock.calls} forwards "
                f"{clock.forward_s / wall:.1%} of the time, metric code "
                f"{clock.metric_s / wall:.1%}, the rest {other / wall:.1%}; "
                f"{headline(res)}")
            if impl == "torch":
                check(all(v == 0 for v in counts.values()),
                      f"{label}: the plain run launched no kernel")
                continue
            want = {k: per[k] * clock.calls for k in per
                    if k in ("fps", "ball_query", "three_nn")}
            check(clock.calls > 0 and all(counts[k] == want[k] for k in want)
                  and counts["gather_rows"] > 0,
                  f"{label} {dtype}: {clock.calls} forwards launched "
                  f"{ {k: per[k] for k in want} } a forward and the gather")
            total = {k: total[k] + counts[k] for k in total}
        check(equal_metrics(results["kernels", "float32"],
                            results["plain", "float32"]),
              f"{label}: f32 metrics through the kernels equal the plain "
              f"versions' on the card ({headline(results['plain', 'float32'])})")
    return total


def headline(res: dict) -> str:
    """The protocol's headline numbers, for the log."""
    if "instance_miou" in res:
        return (f"accuracy {res['accuracy']:.6f}, instance mIoU "
                f"{res['instance_miou']:.6f}")
    if "calibrated_accuracy_vox" in res:
        return (f"point accuracy {res['point_accuracy']:.6f}, calibrated "
                f"voxel accuracy {res['calibrated_accuracy_vox']:.6f}")
    return (f"accuracy {res['accuracy']:.6f}, avg class accuracy "
            f"{res['avg_class_accuracy']:.6f}")


def check_cli(torch, check: Checks, log_dir: str) -> dict:
    """Phase 27: the user's journey through the CLIs on the card, in this
    process: cli.train then cli.evaluate --out of cls_ssg (--synthetic,
    1024 points, B=16, 2 epochs, 12 votes) and of sem_seg (--synthetic,
    8192 points, B=16, 1 epoch, its whole-scene protocol, 2 loader
    threads); the checkpoints, metrics and record must be JAX's, and the
    forwards launch FPS, the ball query, the gather and three_nn. Returns the
    launches."""
    from pointnet2_tpu_torch import ops
    from pointnet2_tpu_torch.cli import evaluate as cli_evaluate
    from pointnet2_tpu_torch.cli import train as cli_train

    log("phase 27: the CLI journey on the card: cli.train, cli.evaluate "
        "--out, for cls_ssg and sem_seg")
    for w in ops.KERNELS.values():
        w.launches = 0
    journeys = (
        (CLS_SSG, ["--num_point", str(N_POINT), "--max_epoch", "2"],
         ["--num_votes", str(PROTOCOL_VOTES)],
         ["train", "eval", "train", "eval"], 40,
         {"accuracy", "avg_class_accuracy", "class_accuracy",
          "per_class_seen"}),
        (SEM, ["--num_point", str(SEM_N), "--max_epoch", "1",
               "--loader_workers", "2"], [],
         ["train", "eval_chopped", "eval_whole_scene"], 1,
         {"chopped", "whole_scene"}),
    )
    for name, train_flags, eval_flags, splits, steps, keys in journeys:
        run_dir = os.path.join(log_dir, f"cli_{name}")
        out = os.path.join(log_dir, f"cli_{name}.json")
        common = ["--model", name, "--synthetic", "--batch_size", "16",
                  "--log_dir", run_dir]
        t0 = time.perf_counter()
        cli_train.main(common + train_flags)
        t1 = time.perf_counter()
        cli_evaluate.main(common + train_flags[:2] + eval_flags
                          + ["--out", out])
        t2 = time.perf_counter()
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        with open(out) as f:
            record = json.load(f)
        meta = {k: json.load(open(os.path.join(run_dir, f"{k}.meta.json")))
                for k in ("ckpt", "best")}
        epochs = int(train_flags[3])
        check([r["split"] for r in rows] == splits
              and all(os.path.isfile(os.path.join(run_dir, k, "state.pt"))
                      for k in ("ckpt", "best"))
              and meta["ckpt"] == {"step": steps, "epoch": epochs}
              and "score" in meta["best"]
              and record.keys() == {"model", "ckpt", "step", "num_votes",
                                    "metrics"}
              and record["model"] == name and record["step"] == steps
              and set(record["metrics"]) == keys,
              f"{name}: cli.train ({t1 - t0:.1f} s) wrote ckpt and best with "
              f"their sidecars {meta}, metrics.jsonl {splits}; cli.evaluate "
              f"({t2 - t1:.1f} s) restored step {record['step']} and wrote "
              f"its record, metrics {sorted(record['metrics'])}")
    counts = {k: w.launches for k, w in ops.KERNELS.items()}
    log(f"  launches in the CLI journeys: {counts}")
    check(all(counts[k] > 0 for k in ("fps", "ball_query", "gather_rows",
                                      "scatter_rows", "three_nn")),
          "the journeys' forwards launched FPS, the ball query, the gather "
          "and three_nn, their steps the scatter")
    return counts


# --- the trainer's switches: K steps a CUDA graph, remat, the watchdog ------

GRAPH_K = 4  # phase 28's steps_per_call
# phase 28's runs, all bf16: (model, batch, config.fused_mlp)
GRAPH_RUNS = ((CLS_SSG, 16, False), (CLS_SSG, 16, True),
              (CLS_SSG, 32, False), (CLS_SSG, 32, True), (SEM, 16, False))
GRAPH_SCENES = 80  # sem_seg's generated rooms: 5 batches of 16
# phase 29's runs, bf16 B=16: (model, config.fused_mlp)
REMAT_RUNS = ((CLS_SSG, False), (CLS_SSG, True), (SEM, False))
# phase 30: the wedged run's --watchdog_secs, the step it wedges and the
# device sleep that wedges it (~25 s at the H100's 1.98 GHz)
WEDGE_SECS, WEDGE_STEP, WEDGE_CYCLES = 8.0, 3, 50_000_000_000
TXT_CLASSES, TXT_SHAPES = 4, 8  # phase 30's generated ModelNet txt tree


def graph_data(name: str, B: int, scenes=None):
    """Phase 28's train data: 6 batches of B synthetic clouds (1024 points,
    24 classes) for cls_ssg, 5 batches of 16 ScanNet crops of ``scenes``
    for sem_seg: K-step calls and an eager remainder."""
    from pointnet2_tpu_torch.data import ScannetDataset, SyntheticClassification

    if name == SEM:
        return ScannetDataset(scenes=scenes, npoints=SEM_N, split="train",
                              batch_size=B, seed=SEED)
    return SyntheticClassification(num_classes=24, samples_per_class=B // 4,
                                   npoints=N_POINT, batch_size=B,
                                   seed=SEED + 30)


def graph_trainer(torch, name: str, B: int, K: int, log_dir: str, **kw):
    return make_trainer(torch, "bfloat16", os.path.join(log_dir, f"graph{K}"),
                        1, model=name, batch_size=B,
                        num_point=SEM_N if name == SEM else N_POINT,
                        augment="scannet" if name == SEM else "cls",
                        steps_per_call=K, **kw)


def check_graphed_steps(torch, check: Checks, log_dir: str, gpu: str) -> dict:
    """Phase 28: an epoch of Trainer.train_epoch with steps_per_call=4 (the
    K-step calls one CUDA graph replay each, the remainder single steps)
    against the same epoch of single steps, bf16: cls_ssg at B=16 and 32,
    the fused chain off and on, and sem_seg at B=16 on 8192-point crops.
    Parameters, BN statistics, moments, count, step and generator bit for
    bit; the graph's launches per replay K times an eager step's, the
    epoch's the steps' and the warm-up's; then the times (time_graphed).
    Returns the launches of the graphed epochs."""
    from pointnet2_tpu_torch import config, ops
    from pointnet2_tpu_torch.data import make_synthetic_scenes

    log(f"phase 28: steps_per_call={GRAPH_K} as one CUDA graph of "
        f"{GRAPH_K} train steps, against single steps, bf16, on {gpu}")
    total = dict.fromkeys(ops.KERNELS, 0)
    scenes = make_synthetic_scenes(GRAPH_SCENES, 20000, seed=SEED + 31)
    for name, B, fused in GRAPH_RUNS:
        tag = f"{name} B={B}{' fused' if fused else ''}"
        snaps, counts = {}, {}
        with config.fused_mlp(fused):
            for K in (1, GRAPH_K):
                train = graph_data(name, B, scenes)
                for w in ops.KERNELS.values():
                    w.launches = 0
                with graph_trainer(torch, name, B, K, log_dir) as tr:
                    state = tr.train_epoch(tr.init_state(), train, 0)
                    torch.cuda.synchronize()
                    counts[K] = {k: w.launches for k, w in ops.KERNELS.items()}
                    snaps[K] = train_snapshot(torch, tr, state)
                    if K > 1:
                        (key, graphed), = tr._multi.graphs.items()
                        capture = tr._multi.capture_s[key]
                        time_graphed(torch, tr, state, train, graphed, tag, B,
                                     capture)
        steps = train.num_batches()
        err, names = snapshot_diff(torch, snaps[1], snaps[GRAPH_K])
        check(not names, f"{tag}: {steps} steps as {steps // GRAPH_K} "
              f"replay(s) of {GRAPH_K} and {steps % GRAPH_K} single steps "
              f"equal {steps} single steps bit for bit ({len(snaps[1])} "
              "tensors: parameters, BN statistics, moments, count, step, "
              f"generator); differing: {names[:4]} (max {err:.3e})")
        per = {k: n // steps for k, n in counts[1].items()}
        check(all(n == per[k] * steps for k, n in counts[1].items())
              and graphed.launches == {k: GRAPH_K * n for k, n in per.items()}
              and counts[GRAPH_K] == {k: (steps + 1) * n
                                      for k, n in per.items()},
              f"{tag}: a replay counts {GRAPH_K} single steps' launches "
              f"({ {k: n for k, n in graphed.launches.items() if n} }); the "
              f"graphed epoch {steps} steps' and the warm-up step's")
        total = {k: total[k] + counts[GRAPH_K][k] for k in total}
    return total


def time_graphed(torch, tr, state, train, graphed, tag: str, B: int,
                 capture_s: float) -> None:
    """Phase 28's times on the graphed epoch's trainer: ms/step and
    examples/s (host clock, median of 5) of a single step on a batch
    already on the card (as phases 21 and 24 time it), of a single step
    uploading its batch (as the trainer runs it) and of a K-step call on K
    host batches; device time a step (torch.profiler's busy time for the
    single step, CUDA events around a replay for the graph) and the idle
    share; peak memory of each (a replay allocates nothing: its
    activations live in the graph's private pool, whose reserved bytes are
    logged beside it); the capture's time."""
    from pointnet2_tpu_torch.train.steps import run_one_step

    K = GRAPH_K
    raw = [b for _, b in zip(range(K), train.epoch())]
    host = [tr._host_view(b) for b in raw]
    resident = tr._to_device(raw[0])
    args = (tr.loss_fn, tr.bn_schedule, tr.augment_fn, tr.generator, tr.task)

    def eager():
        run_one_step(state, resident, *args)

    def uploaded():
        run_one_step(state, tr._to_device(raw[0]), *args)

    calls = {"single step": eager, "single step + upload": uploaded,
             f"{K}-step graph": lambda: tr._multi(host)}
    rows = []
    for label, fn in calls.items():
        per = K if label.endswith("graph") else 1
        ms = host_ms(torch, fn, 5, warmup=2) / per
        if per == 1:
            kernels, _, _, _ = trace_device(torch, fn, 2)
            dev_ms = sum(r[0] for r in kernels) / 1e3
        else:
            dev_ms = event_ms(torch, graphed.graph.replay, 5,
                              prefill=True) / K
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rows.append(f"{label} {ms:.3f} ms/step ({B / ms * 1e3:.1f} "
                    f"examples/s), device {dev_ms:.3f} ms/step (idle "
                    f"{1 - dev_ms / ms:.1%}), peak {peak:.3f} GiB")
    pool = tuple(graphed.graph.pool())
    pool_gib = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool) / 2 ** 30
    log(f"  {tag} bf16 times: " + "; ".join(rows)
        + f"; the graph's pool {pool_gib:.3f} GiB; capture "
        f"{capture_s * 1e3:.1f} ms (warm-up step included)")


def check_graph_resume(torch, check: Checks, log_dir: str) -> dict:
    """Phase 28b: cls_ssg bf16 with the fused chain, B=16 (phase 25's data:
    5 batches an epoch, so a replay of 4 and a single step), 2 epochs with
    steps_per_call=4, stopped and resumed to 4 by a new Trainer, against 4
    uninterrupted epochs of single steps, bit for bit. Returns the
    launches of the graphed runs."""
    from pointnet2_tpu_torch import config, ops

    first, last = RESUME_EPOCHS
    with config.fused_mlp(True):
        train, evals = resume_data()
        with make_trainer(torch, "bfloat16", os.path.join(
                log_dir, "graph_resume_ref"), last) as tr:
            want = train_snapshot(torch, tr, tr.fit(train, eval_dataset=evals))
        train, evals = resume_data()
        run_dir = os.path.join(log_dir, "graph_resume")
        for w in ops.KERNELS.values():
            w.launches = 0
        with make_trainer(torch, "bfloat16", run_dir, last,
                          steps_per_call=GRAPH_K) as tr:
            tr.fit(train, eval_dataset=evals, max_epoch=first)
        with make_trainer(torch, "bfloat16", run_dir, last,
                          steps_per_call=GRAPH_K) as tr:
            got = train_snapshot(torch, tr, tr.fit(train, eval_dataset=evals))
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in ops.KERNELS.items()}
    err, names = snapshot_diff(torch, want, got)
    check(not names, f"cls_ssg bf16 fused: {first} + {last - first} epochs "
          f"with steps_per_call={GRAPH_K} and a resume equal {last} "
          f"uninterrupted epochs of single steps bit for bit ({len(got)} "
          f"tensors); differing: {names[:4]} (max {err:.3e})")
    return counts


def check_remat(torch, dev, check: Checks, log_dir: str, gpu: str,
                seg_batches: dict) -> dict:
    """Phase 29: two train steps under each remat policy (none, full, dots,
    dots_nobatch) from the same weights, batch and generator seed, bf16
    B=16: cls_ssg with the fused chain off and on, sem_seg on phase 22's
    crop. Gradients, parameters, BN statistics, moments and the generator
    bit for bit those of "none"; a third step's peak memory (absolute and
    above the state's resident memory), ms/step (host clock, median of 5)
    and launches. Returns the launches of the steps."""
    from pointnet2_tpu_torch import config, ops
    from pointnet2_tpu_torch.train.steps import REMAT_POLICIES, run_one_step

    log(f"phase 29: remat policies, two bf16 train steps at B=16 against "
        f"remat='none', on {gpu}")
    total = dict.fromkeys(ops.KERNELS, 0)
    for name, fused in REMAT_RUNS:
        tag = f"{name}{' fused' if fused else ''}"
        n = SEM_N if name == SEM else N_POINT
        got = {}
        for remat in REMAT_POLICIES:
            with config.fused_mlp(fused), make_trainer(
                    torch, "bfloat16", os.path.join(log_dir, "remat"), 1,
                    model=name, num_point=n,
                    augment="scannet" if name == SEM else "cls",
                    remat=remat) as tr:
                batch = (tr._to_device(seg_batches[SEM]) if name == SEM
                         else train_batch(torch, dev))
                state = tr.init_state()
                tr.generator.manual_seed(5)

                def step():
                    run_one_step(state, batch, tr.loss_fn, tr.bn_schedule,
                                 tr.augment_fn, tr.generator, tr.task,
                                 remat=remat)

                for w in ops.KERNELS.values():
                    w.launches = 0
                step()
                step()
                torch.cuda.synchronize()
                counts = {k: w.launches for k, w in ops.KERNELS.items()}
                snap = train_snapshot(torch, tr, state)
                snap.update({f"grad {k}": p.grad.clone()
                             for k, p in state.model.named_parameters()})
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                step()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                ms = host_ms(torch, step, 5, warmup=1)
            total = {k: total[k] + counts[k] for k in total}
            got[remat] = snap
            log(f"  {tag} remat={remat}: {ms:.3f} ms/step, peak "
                f"{peak / 2 ** 30:.3f} GiB ({(peak - resident) / 2 ** 30:.3f}"
                f" GiB above the resident state), launches of two steps "
                f"{ {k: v for k, v in counts.items() if v} }")
        for remat in REMAT_POLICIES:
            if remat == "none":
                continue
            err, names = snapshot_diff(torch, got["none"], got[remat])
            check(not names, f"{tag}: remat={remat} equals remat='none' bit "
                  f"for bit over two steps ({len(got[remat])} tensors: "
                  "gradients, parameters, BN statistics, moments, count, "
                  f"step, generator); differing: {names[:4]} (max "
                  f"{err:.3e})")
    return total


WEDGE_SCRIPT = """\
import os
import sys

sys.path.insert(0, {root!r})
import torch  # noqa: E402

from pointnet2_tpu_torch.cli import train as cli_train  # noqa: E402
from pointnet2_tpu_torch.train import trainer as trainer_mod  # noqa: E402

marker, wedge_step, cycles = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
real_init, real_step = trainer_mod.Trainer.__init__, trainer_mod.run_one_step


def init(self, config, *args, **kw):
    config.ckpt_every_epochs = 1  # a checkpoint every epoch to resume from
    real_init(self, config, *args, **kw)


def step(state, *args, **kw):
    if state.step == wedge_step and not os.path.exists(marker):
        open(marker, "w").close()
        torch.cuda._sleep(cycles)  # the card busy, no step completes
        torch.cuda.synchronize()
    return real_step(state, *args, **kw)


trainer_mod.Trainer.__init__ = init
trainer_mod.run_one_step = step
cli_train.main(sys.argv[4:])
"""


def check_watchdog(torch, check: Checks, log_dir: str) -> None:
    """Phase 30a: cli.supervise's loop around a cli.train subprocess
    (cls_ssg, synthetic, 3 epochs of 3 steps, a checkpoint an epoch,
    --watchdog_secs 8) whose step 3, the first of epoch 2, is wedged by a
    device sleep of about 25 s: the watchdog exits it with 75, the
    supervisor restarts it, and the restarted run resumes from the epoch-1
    checkpoint and ends at step 9."""
    from pointnet2_tpu_torch.cli import supervise as sup
    from pointnet2_tpu_torch.train import checkpoint as ckpt

    log(f"phase 30: the stall watchdog and cli.supervise: a cli.train "
        f"subprocess wedged at step {WEDGE_STEP} past --watchdog_secs "
        f"{WEDGE_SECS:g}")
    run_dir = os.path.join(log_dir, "wedged")
    script = os.path.join(log_dir, "wedged_train.py")
    marker = os.path.join(log_dir, "wedged.marker")
    with open(script, "w") as f:
        f.write(WEDGE_SCRIPT.format(
            root=os.path.dirname(os.path.abspath(__file__))))
    cmd = [sys.executable, script, marker, str(WEDGE_STEP), str(WEDGE_CYCLES),
           "--model", CLS_SSG, "--synthetic", "--synthetic_size", "1",
           "--batch_size", "16", "--max_epoch", "3", "--log_dir", run_dir,
           "--watchdog_secs", str(WEDGE_SECS)]
    said = []
    t0 = time.perf_counter()
    rc = sup.supervise(cmd, max_restarts=2, backoff_secs=0.0,
                       log_fn=said.append)
    dt = time.perf_counter() - t0
    with open(os.path.join(run_dir, "log_train.txt")) as f:
        text = f.read()
    check(rc == 0 and os.path.exists(marker)
          and any("stall #1" in m for m in said)
          and "WATCHDOG" in text
          and f"restored checkpoint at step {WEDGE_STEP} (epoch 1)" in text
          and ckpt.load_meta(run_dir) == {"step": 9, "epoch": 3},
          f"the wedged run exited 75 on its watchdog, cli.supervise "
          f"restarted it, the restart resumed at step {WEDGE_STEP} (epoch 1) "
          f"and ended at step 9, rc {rc} ({dt:.1f} s; supervise: {said})")


def write_modelnet_txt(root: str) -> None:
    """A resampled-txt ModelNet tree (modelnet40_normal_resampled's layout)
    of TXT_CLASSES classes, TXT_SHAPES shapes each (3 in 4 in the train
    split), 2048 surface points with normals a shape."""
    names = [f"shape{c}" for c in range(TXT_CLASSES)]
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "modelnet40_shape_names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    clouds = make_clouds(TXT_CLASSES * TXT_SHAPES, PART_N, SEED + 40,
                         normals=True)
    splits = {"train": [], "test": []}
    for i, pts in enumerate(clouds):
        cls = names[i % TXT_CLASSES]
        sid = f"{cls}_{i:04d}"
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        np.savetxt(os.path.join(root, cls, sid + ".txt"), pts, delimiter=",",
                   fmt="%.6f")
        splits["test" if i % 4 == 3 else "train"].append(sid)
    for split, ids in splits.items():
        with open(os.path.join(root, f"modelnet40_{split}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")


def check_normal_txt(torch, check: Checks, log_dir: str) -> dict:
    """Phase 30b: cli.train --normal on a generated ModelNet txt tree
    (1024 of each shape's 2048 points with normals, B=16, 2 epochs,
    steps_per_call 2, on-device cls_normals), then Trainer.fit of the same
    data with the host chain augment_cls_batch_with_normals
    (host_augment=True). Returns the launches."""
    from pointnet2_tpu_torch import ops
    from pointnet2_tpu_torch.cli import train as cli_train
    from pointnet2_tpu_torch.data import ModelNetDataset

    root = os.path.join(log_dir, "modelnet40_normal_resampled")
    write_modelnet_txt(root)
    run_dir = os.path.join(log_dir, "cli_normal")
    for w in ops.KERNELS.values():
        w.launches = 0
    cli_train.main(["--model", CLS_SSG, "--normal", "--data", root,
                    "--batch_size", "16", "--max_epoch", "2",
                    "--steps_per_call", "2", "--log_dir", run_dir])
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(run_dir, "ckpt.meta.json")) as f:
        meta = json.load(f)
    check([r["split"] for r in rows] == ["train", "eval"] * 2
          and cfg["augment"] == "cls_normals"
          and cfg["model_kwargs"] == {"in_channels": 6}
          and meta == {"step": 4, "epoch": 2}
          and all(np.isfinite(r["loss"]) for r in rows if "loss" in r),
          f"cli.train --normal on the txt tree: {len(rows)} records, "
          f"augment {cfg['augment']}, ckpt {meta}")
    with make_trainer(torch, "bfloat16", os.path.join(log_dir, "host_aug"), 2,
                      augment="none", host_augment=True,
                      model_kwargs={"in_channels": 6}) as tr:
        train = ModelNetDataset(root, batch_size=16, npoints=N_POINT)
        state = tr.fit(train)
    with open(os.path.join(log_dir, "host_aug", "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    check(state.step == 4 and len(losses) == 2
          and all(np.isfinite(losses)),
          f"Trainer.fit with host_augment on the txt data (the host chain "
          f"augment_cls_batch_with_normals): 4 steps, train losses {losses}")
    return {k: w.launches for k, w in ops.KERNELS.items()}


# ---------------------------------------------------------------------------
# phase 31: scale-out (data parallelism over ranks)
# ---------------------------------------------------------------------------

# (tag, model, compute dtype, fused chain) of phase 31's train steps; the
# float64 one runs the plain versions (the kernels take f32 and bf16),
# where the collectives' summation order is all that differs
SCALE_CASES = (("cls_ssg f64 plain", CLS_SSG, "float64", False),
               ("cls_ssg f32", CLS_SSG, "float32", False),
               ("cls_ssg f32 fused", CLS_SSG, "float32", True),
               ("cls_ssg bf16", CLS_SSG, "bfloat16", False),
               ("cls_ssg bf16 fused", CLS_SSG, "bfloat16", True),
               ("sem_seg bf16", SEM, "bfloat16", False))
SCALE_ROWS = 16  # rows a rank of phase 31's steps
# a step on N ranks against one process's on the global batch: loss and
# running statistics (relative to each tensor's scale), the largest
# gradient difference and the median (grad_differences). Only the float64
# step holds the math tightly: in f32 and bf16 the per-rank statistics'
# last bits move BN's E[x^2] - E[x]^2 and, in bf16, the rounding of every
# activation, as any two routes do (phases 20 and 22). Measured on an
# H100 at 700 W (2 ranks; 4): float64 gradients 5.8e-14 (8.6e-14)
# largest, f32 5.9e-3 (1.4e-2) and medians 1.1e-4-1.2e-4 (1.4e-3-2.7e-3),
# bf16 0.67 (0.63) and medians 0.20-0.36 (0.19-0.26), bf16 loss 3.1e-3
SCALE_TOL = {"float64": (1e-12, 1e-10, 1e-9, 1e-9),
             "float32": (1e-5, 1e-4, 5e-2, 1e-2),
             "bfloat16": (1e-2, 5e-2, 1.0, 0.5)}
WEAK_RUNS = ((CLS_SSG, 32, True), (SEM, 16, False))  # (model, rows a rank,
WEAK_CALLS = 8  # fused) of the weak-scaling runs; timed calls of K steps
SPAWN_TIMEOUT = 240  # s a phase-31 job of ranks may take (exit 124 past it)


def scale_batch(name: str, B: int) -> dict:
    """Phase 31's host batch of B rows in the step's layout, the last row
    padding (mask 0): phase 3's clouds for cls_ssg; for sem_seg random 1.5 m
    columns of 8192 points with labels and point weights."""
    rng = np.random.default_rng(SEED + 31)
    mask = np.ones(B, np.float32)
    mask[-1] = 0.0
    if name == SEM:
        pts = rng.uniform(0.0, 1.0, (B, SEM_N, 3)) * [1.5, 1.5, 3.0]
        return {"points": pts.astype(np.float32),
                "seg": rng.integers(0, 21, (B, SEM_N)),
                "smpw": rng.uniform(0.5, 2.0, (B, SEM_N)).astype(np.float32),
                "mask": mask}
    return {"points": make_clouds(B, N_POINT, SEED + 31),
            "label": np.arange(B, dtype=np.int64) % NUM_CLASSES,
            "mask": mask}


def scale_steps(torch, device, B: int, log_dir: str) -> dict:
    """One train step of each SCALE_CASES case from the seeded weights on
    this process's rows of the global batch of B (all of it without a
    process group), the generator at seed 5 (augmentation and dropout draw
    for the global batch), and the eval counts of the initial weights on
    the batch, summed over the ranks. Returns CPU copies."""
    from pointnet2_tpu_torch import config
    from pointnet2_tpu_torch.parallel.mesh import shard_batch
    from pointnet2_tpu_torch.train.state import make_optimizer
    from pointnet2_tpu_torch.train.steps import eval_counts, run_one_step

    out = {}
    for tag, name, dtype, fused in SCALE_CASES:
        f64 = dtype == "float64"
        with make_trainer(torch, "float32" if f64 else dtype,
                          os.path.join(log_dir, "scale"), 1, model=name,
                          batch_size=B, device=device,
                          num_point=SEM_N if name == SEM else N_POINT,
                          augment="scannet" if name == SEM else "cls") as tr:
            state = tr.init_state()
            state.model.load_state_dict(random_state_dict(torch, SEED, name))
            host = scale_batch(name, B)
            if f64:
                state.model.double()
                state.optimizer = make_optimizer(
                    "adam", state.model.parameters(), tr.lr_schedule)
                host = {k: v.astype(np.float64) if v.dtype == np.float32
                        else v for k, v in host.items()}
            batch = shard_batch(tr.mesh, host)
            with config.default_impl("torch" if f64 else "auto"):
                counts = eval_counts(state.model, batch, tr.task, tr.mesh)
                tr.generator.manual_seed(5)
                with config.fused_mlp(fused):
                    m = run_one_step(state, batch, tr.loss_fn,
                                     tr.bn_schedule, tr.augment_fn,
                                     tr.generator, tr.task, mesh=tr.mesh)
            opt = state.optimizer.state_dict()
            model = state.model
            out[tag] = {
                "loss": float(m["loss"]),
                "grads": {k: p.grad.cpu() for k, p in
                          model.named_parameters()},
                "buffers": {k: b.cpu() for k, b in model.named_buffers()},
                "params": {k: p.detach().cpu() for k, p in
                           model.named_parameters()},
                "moments": [t.cpu() for k in state.optimizer.MOMENTS
                            for t in opt[k]],
                "generator": tr.generator.get_state(),
                "counts": [c.cpu() for c in counts]}
    return out


def scale_rank(out_dir: str, B: int, device: str) -> None:
    """Phase 31: a rank's scale_steps and its launches, saved for the
    parent."""
    import torch
    import torch.distributed as dist

    from pointnet2_tpu_torch import ops

    for w in ops.KERNELS.values():
        w.launches = 0
    steps = scale_steps(torch, device, B, out_dir)
    torch.cuda.synchronize()
    torch.save({"steps": steps,
                "launches": {k: w.launches for k, w in ops.KERNELS.items()}},
               os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))


def bits_equal(torch, a: dict, b: dict) -> bool:
    """Two ranks' states of one step bit for bit."""
    return (all(torch.equal(a[g][k], b[g][k]) for g in ("params", "buffers")
                for k in a[g])
            and all(torch.equal(x, y) for x, y in zip(a["moments"],
                                                       b["moments"]))
            and torch.equal(a["generator"], b["generator"]))


def check_scale_steps(torch, check: Checks, log_dir: str, n: int,
                      device: str, backend: str) -> dict:
    """Phase 31a (two gloo ranks sharing cuda:0) and 31c (n NCCL ranks, a
    card each): each SCALE_CASES step on n ranks of SCALE_ROWS rows against
    one process's step on the same global batch and weights on cuda:0. The
    ranks hold the same state bit for bit; loss and running statistics,
    gradients (largest and median of grad_differences) within SCALE_TOL;
    the eval counts summed over the ranks equal. Returns the ranks'
    launches."""
    from pointnet2_tpu_torch import get_model, ops
    from pointnet2_tpu_torch.parallel import launch

    B = SCALE_ROWS * n
    out_dir = os.path.join(log_dir, f"scale_{backend}{n}")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    rc = launch.spawn(scale_rank, n, device=device, backend=backend,
                      args=(out_dir, B, device), timeout=SPAWN_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    launches = dict.fromkeys(ops.KERNELS, 0)
    if not check(rc == 0, f"{n} {backend} ranks on {device}: one step of "
                 f"{len(SCALE_CASES)} cases at global B={B}, exit code "
                 f"{rc}, {spawn_s:.1f} s"):
        return launches
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(n)]
    one = scale_steps(torch, "cuda:0" if "cuda" in device else device, B,
                      log_dir)
    for tag, name, dtype, _ in SCALE_CASES:
        got, want = [r["steps"][tag] for r in ranks], one[tag]
        same = all(bits_equal(torch, got[0], g) for g in got[1:])
        loss_err = abs(got[0]["loss"] - want["loss"]) / abs(want["loss"])
        stats_err = max(float((got[0]["buffers"][k] - b).abs().max()
                              / b.abs().max().clamp_min(1e-30))
                        for k, b in want["buffers"].items())
        zero = exact_zero_biases(get_model(name, device="cpu"))
        diffs = grad_differences(torch, got[0]["grads"], want["grads"], zero)
        median = float(np.median([d for d, _ in diffs]))
        # eval_counts sums over the ranks itself
        counts = all(torch.equal(a, b) for a, b in zip(got[0]["counts"],
                                                       want["counts"]))
        tl, ts, tg, tm = SCALE_TOL[dtype]
        check(same and counts and np.isfinite(got[0]["loss"])
              and loss_err <= tl and stats_err <= ts and diffs[0][0] <= tg
              and median <= tm,
              f"{tag}, {n} {backend} ranks vs one process, global B={B}: "
              f"ranks bit-identical {same}; loss {got[0]['loss']:.6f} vs "
              f"{want['loss']:.6f} (rel {loss_err:.2e}, bound {tl:g}); "
              f"running statistics {stats_err:.2e} (bound {ts:g}); gradients"
              f" of {len(diffs)} tensors: largest {diffs[0][0]:.2e} "
              f"({diffs[0][1]}), median {median:.2e} (bounds {tg:g}, "
              f"{tm:g}); eval counts summed over the ranks equal {counts}")
    for r in ranks:
        launches = {k: launches[k] + r["launches"][k] for k in launches}
    return launches


def one_rank_epoch(torch, log_dir: str) -> dict:
    """Phase 31b's epoch: fused bf16 cls_ssg, 6 batches of 16 with
    steps_per_call=4 (a CUDA graph replay, then 2 single steps); returns
    the end state's snapshot and the number of graphs."""
    from pointnet2_tpu_torch import config

    with config.fused_mlp(True), graph_trainer(torch, CLS_SSG, 16, GRAPH_K,
                                               log_dir, num_devices=1) as tr:
        state = tr.train_epoch(tr.init_state(), graph_data(CLS_SSG, 16), 0)
        torch.cuda.synchronize()
        return {"snapshot": train_snapshot(torch, tr, state),
                "graphs": len(tr._multi.graphs)}


def one_rank_nccl(out_dir: str) -> None:
    """Phase 31b: one rank of an NCCL group: one_rank_epoch with every
    collective of the step captured in its graph; saved with its
    launches."""
    import torch

    from pointnet2_tpu_torch import ops

    for w in ops.KERNELS.values():
        w.launches = 0
    run = one_rank_epoch(torch, out_dir)
    run["snapshot"] = {k: v.cpu() for k, v in run["snapshot"].items()}
    run["launches"] = {k: w.launches for k, w in ops.KERNELS.items()}
    torch.save(run, os.path.join(out_dir, "rank0.pt"))


def gloo_graph_rank(out_dir: str) -> None:
    """Phase 31b: a gloo rank on cuda:0 asks for a CUDA graph of its step,
    which would capture gloo's collectives: TrainMultiStep must refuse."""
    import torch

    with graph_trainer(torch, CLS_SSG, 16, GRAPH_K, out_dir) as tr:
        try:
            tr.multi_step(tr.init_state())
        except RuntimeError as e:
            with open(os.path.join(out_dir, "refused.txt"), "w") as f:
                f.write(str(e))


def check_one_rank_nccl(torch, check: Checks, log_dir: str) -> dict:
    """Phase 31b: one_rank_epoch in a group of one NCCL rank on cuda:0 (an
    all-reduce over one rank is a copy) equals it without a group bit for
    bit; Predictor(num_devices=1) serves today's logits bit for bit; no
    fallback: a graphed step over gloo on the card and more CUDA ranks than
    cards raise. Returns the rank's launches."""
    from pointnet2_tpu_torch import Predictor, ops
    from pointnet2_tpu_torch.parallel import launch

    gloo_dir = os.path.join(log_dir, "scale_gloo_graph")
    os.makedirs(gloo_dir, exist_ok=True)
    rc = launch.spawn(gloo_graph_rank, 1, device="cuda:0", backend="gloo",
                      args=(gloo_dir,), timeout=SPAWN_TIMEOUT)
    refused = os.path.join(gloo_dir, "refused.txt")
    why = open(refused).read() if os.path.isfile(refused) else ""
    check(rc == 0 and "needs NCCL" in why,
          f"TrainMultiStep on a gloo rank on cuda:0 refuses: {why[:90]!r}")
    try:
        launch.spawn(gloo_graph_rank, torch.cuda.device_count() + 1,
                     device="cuda", args=(gloo_dir,))
        raised = ""
    except ValueError as e:
        raised = str(e)
    check("card" in raised, f"{torch.cuda.device_count() + 1} CUDA ranks "
          f"on {torch.cuda.device_count()} card(s) raise: {raised!r}")

    out_dir = os.path.join(log_dir, "scale_nccl1")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    rc = launch.spawn(one_rank_nccl, 1, device="cuda", args=(out_dir,),
                      timeout=SPAWN_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    if not check(rc == 0, f"one NCCL rank: a fused bf16 cls_ssg epoch with "
                 f"steps_per_call={GRAPH_K}, exit code {rc}, "
                 f"{spawn_s:.1f} s"):
        return dict.fromkeys(ops.KERNELS, 0)
    ranked = torch.load(os.path.join(out_dir, "rank0.pt"), weights_only=False)
    alone = one_rank_epoch(torch, os.path.join(log_dir, "scale_alone"))
    err, names = snapshot_diff(torch, ranked["snapshot"],
                               {k: v.cpu() for k, v in
                                alone["snapshot"].items()})
    check(not names and ranked["graphs"] == alone["graphs"] == 1,
          f"Trainer(num_devices=1) in a one-rank NCCL group, its graph "
          f"capturing the step's collectives: the epoch equals the trainer "
          f"without a group bit for bit ({len(alone['snapshot'])} tensors; "
          f"differing: {names[:4]}, max {err:.3e}); graphs "
          f"{ranked['graphs']}")
    sd = random_state_dict(torch, SEED)
    clouds = make_clouds(16, N_POINT, SEED + 1)
    a = Predictor(CLS_SSG, sd)(clouds)
    b = Predictor(CLS_SSG, sd, num_devices=1)(clouds)
    check(np.array_equal(a, b), "Predictor(num_devices=1): today's bf16 "
          "logits bit for bit, 16 clouds")
    return ranked["launches"]


def weak_rank(out_dir: str, ranks: int) -> None:
    """Phase 31c: a rank's weak-scaling runs (WEAK_RUNS, bf16,
    steps_per_call=4 graph replays): ms a call of K steps (host clock), the
    gradient all-reduce's ms (CUDA events, the flat float32 buffer of every
    parameter) and an eager step's device time and its NCCL kernels'
    (torch.profiler, trace_device); saved by rank 0."""
    import torch
    import torch.distributed as dist

    from pointnet2_tpu_torch import config
    from pointnet2_tpu_torch.parallel.mesh import local_rows
    from pointnet2_tpu_torch.train.steps import run_one_step

    res = {}
    for name, rows, fused in WEAK_RUNS:
        B = rows * ranks
        with config.fused_mlp(fused), make_trainer(
                torch, "bfloat16", os.path.join(out_dir, "weak"), 1,
                model=name, batch_size=B, steps_per_call=GRAPH_K,
                num_point=SEM_N if name == SEM else N_POINT,
                augment="scannet" if name == SEM else "cls",
                num_devices=ranks) as tr:
            state = tr.init_state()
            host = tr._host_view(dict(scale_batch(name, B), nvalid=B))
            batches = [local_rows(tr.mesh, host)] * GRAPH_K
            step = tr.multi_step(state)
            for _ in range(2):  # capture, then a warm replay
                step(batches)
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(WEAK_CALLS):
                step(batches)
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t0) * 1e3 / WEAK_CALLS
            flat = torch.cat([p.detach().reshape(-1).float()
                              for p in state.model.parameters()])
            grad_ms = event_ms(torch, lambda: tr.mesh.mean(flat), 20)
            dev_batch = {k: torch.from_numpy(v).to(tr.device)
                         for k, v in batches[0].items()}
            kernels, _, _, _ = trace_device(torch, lambda: run_one_step(
                state, dev_batch, tr.loss_fn, tr.bn_schedule, tr.augment_fn,
                tr.generator, tr.task, mesh=tr.mesh), 3)
            nccl = [(us, n) for us, n, k in kernels if "nccl" in k.lower()]
            res[name] = {"B": B, "call_ms": call_ms, "grad_ms": grad_ms,
                         "grad_mb": flat.numel() * 4 / 1e6,
                         "device_us": sum(us for us, _, _ in kernels),
                         "nccl_us": sum(us for us, _ in nccl),
                         "nccl_n": sum(n for _, n in nccl)}
    if dist.get_rank() == 0:
        torch.save(res, os.path.join(out_dir, f"weak{ranks}.pt"))


def run_cli(name: str, *flags: str) -> subprocess.CompletedProcess:
    """``python -m pointnet2_tpu_torch.cli.<name> flags`` in a process
    group of its own, killed with every rank it started after
    SPAWN_TIMEOUT (return code 124)."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(
        __file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", f"pointnet2_tpu_torch.cli.{name}", *flags],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=SPAWN_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
        return subprocess.CompletedProcess(proc.args, 124, out, err)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def check_multi_card(torch, check: Checks, log_dir: str, gpu: str,
                     n: int) -> dict:
    """Phase 31c, where the machine has n >= 2 cards: the 31a steps on n
    NCCL ranks (a card each) at global B=16n; cli.train --num_devices n
    --synthetic for an epoch and cli.evaluate on its checkpoint;
    Predictor(num_devices=n) against num_devices=1 (f32, phase 3's 1e-5 of
    the logits' range); and weak scaling at 1, 2 and n ranks. Returns the
    ranks' launches."""
    from pointnet2_tpu_torch import Predictor
    from pointnet2_tpu_torch.parallel import launch

    launches = check_scale_steps(torch, check, log_dir, n, "cuda", "nccl")
    run_dir = os.path.join(log_dir, f"cli_nccl{n}")
    shutil.rmtree(run_dir, ignore_errors=True)
    flags = ["--model", CLS_SSG, "--synthetic", "--synthetic_size", "2",
             "--batch_size", str(16 * n), "--log_dir", run_dir]
    t0 = time.perf_counter()
    train = run_cli("train", *flags, "--max_epoch", "1", "--num_devices",
                    str(n), "--dtype", "bfloat16", "--steps_per_call", "2")
    out = os.path.join(run_dir, "eval.json")
    evaluate = run_cli("evaluate", *flags, "--num_votes", "2", "--out", out)
    record = {}
    if evaluate.returncode == 0 and os.path.isfile(out):
        with open(out) as f:
            record = json.load(f)
    check(train.returncode == 0 and evaluate.returncode == 0
          and record.get("step") == -(-80 // (16 * n))
          and 0.0 <= record["metrics"]["accuracy"] <= 1.0,
          f"cli.train --num_devices {n} --synthetic (80 clouds, batch "
          f"{16 * n}, bf16, steps_per_call 2) then cli.evaluate: exit codes "
          f"{train.returncode}, {evaluate.returncode}, step "
          f"{record.get('step')}, vote accuracy "
          f"{record.get('metrics', {}).get('accuracy')}; "
          f"{time.perf_counter() - t0:.1f} s"
          + "".join(f"; {p.stderr[-800:]}" for p in (train, evaluate)
                    if p.returncode))
    sd = random_state_dict(torch, SEED)
    clouds = make_clouds(100, N_POINT, SEED + 1)
    one = Predictor(CLS_SSG, sd, dtype=torch.float32)
    many = Predictor(CLS_SSG, sd, dtype=torch.float32, num_devices=n)
    for b in (1, 16, 100):
        want, got = one(clouds[:b]), many(clouds[:b])
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        check(got.shape == want.shape and err <= 1e-5 * scale,
              f"Predictor(num_devices={n}) f32, {b} clouds (buckets "
              f"{many._buckets}): max abs diff {err:.3e} against one card "
              f"(logit range {scale:.3f})")
    log(f"phase 31c: weak scaling, bf16, steps_per_call={GRAPH_K}, on {n} x "
        f"{gpu}")
    weak = {}
    for ranks in sorted({1, 2, n}):
        out_dir = os.path.join(log_dir, "weak")
        os.makedirs(out_dir, exist_ok=True)
        rc = launch.spawn(weak_rank, ranks, device="cuda",
                          args=(out_dir, ranks), timeout=SPAWN_TIMEOUT)
        if check(rc == 0, f"weak scaling on {ranks} rank(s): exit code "
                 f"{rc}"):
            weak[ranks] = torch.load(os.path.join(out_dir,
                                                  f"weak{ranks}.pt"))
    for name, rows, fused in WEAK_RUNS:
        base = None
        for ranks, res in sorted(weak.items()):
            r = res[name]
            rate = GRAPH_K * r["B"] / r["call_ms"] * 1e3
            base = base or rate
            share = r["nccl_us"] / max(r["device_us"], 1e-9)
            rest = max(r["nccl_us"] - r["grad_ms"] * 1e3, 0.0)
            log(f"  {name}{' fused' if fused else ''} {rows} a rank, "
                f"{ranks} rank(s), global B={r['B']}: "
                f"{r['call_ms'] / GRAPH_K:.3f} ms/step, {rate:.1f} "
                f"examples/s, efficiency {rate / (ranks * base):.3f}; "
                f"gradient all-reduce of {r['grad_mb']:.2f} MB "
                f"{r['grad_ms'] * 1e3:.1f} us (CUDA events); an eager "
                f"step's device time {r['device_us'] / 1e3:.3f} ms, NCCL "
                f"kernels {r['nccl_n']:.0f} a step, {r['nccl_us']:.1f} us, "
                f"{share:.4f} of it; less the gradient's all-reduce "
                f"(the BN, chain-total and metric all-reduces) "
                f"{rest:.1f} us, {rest / max(r['device_us'], 1e-9):.4f}")
    return launches


def check_scale_out(torch, check: Checks, log_dir: str, gpu: str) -> list:
    """Phase 31: scale-out. 31a on every machine: two gloo ranks sharing
    cuda:0 against one process; 31b: one NCCL rank; 31c where the machine
    has more than one card. Returns the launches of each run."""
    n = torch.cuda.device_count()
    log(f"phase 31: data parallelism over ranks (torch.distributed) on "
        f"{n} x {gpu}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs = [check_scale_steps(torch, check, log_dir, 2, "cuda:0", "gloo"),
            check_one_rank_nccl(torch, check, log_dir)]
    log(f"  phase 31a-b: {time.perf_counter() - t0:.1f} s")
    if n >= 2:
        t0 = time.perf_counter()
        runs.append(check_multi_card(torch, check, log_dir, gpu, n))
        log(f"  phase 31c: {time.perf_counter() - t0:.1f} s")
    else:
        log("  phase 31c: skipped, one card (it needs two or more)")
    return runs


# ---------------------------------------------------------------------------
# phase 32: the procedural stand-ins and the virtual scan
# ---------------------------------------------------------------------------

# phase 32a's sizes: ModelNet shapes a class (train, test), ShapeNet-part
# shapes a category (train, val, test), ScanNet rooms (train, test; each
# at the generator's 60-180k points)
STANDIN_MODELNET = (2, 1)
STANDIN_PART = (1, 1, 1)
STANDIN_ROOMS = (3, 2)
VSCAN_EPOCHS, VSCAN_BATCH = 2, 8  # phase 32b's cli.train


def generate_standins(root: str) -> tuple:
    """Phase 32a: the three generators through their ``python -m`` entry
    points, in subprocesses started together; the HDF5 layout only where
    h5py imports. Returns (the failed commands' tails, whether HDF5 was
    written)."""
    try:
        import h5py  # noqa: F401
        has_h5 = True
    except ImportError:
        has_h5 = False
    tr, te = (str(n) for n in STANDIN_MODELNET)
    mn = ["--train_per_class", tr, "--test_per_class", te]
    jobs = [("procedural_modelnet", ["--out", os.path.join(root, "txt"),
                                     "--format", "txt", *mn]),
            ("procedural_shapenet_part", [
                "--out", os.path.join(root, "part"), "--train_per_class",
                str(STANDIN_PART[0]), "--val_per_class", str(STANDIN_PART[1]),
                "--test_per_class", str(STANDIN_PART[2])]),
            ("procedural_scannet", ["--out", os.path.join(root, "scannet"),
                                    "--train", str(STANDIN_ROOMS[0]),
                                    "--test", str(STANDIN_ROOMS[1])])]
    if has_h5:
        jobs.append(("procedural_modelnet",
                     ["--out", os.path.join(root, "h5"), *mn]))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(
        __file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"pointnet2_tpu_torch.data.{mod}", *flags],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mod, flags in jobs]
    failed = []
    for (mod, flags), proc in zip(jobs, procs):
        try:
            out, err = proc.communicate(timeout=SPAWN_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{mod} {flags}: rc {proc.returncode}, "
                          f"{err[-500:]}")
        else:
            log(f"  {mod}: {out.strip()}")
    return failed, has_h5


def check_standin_layouts(root: str, has_h5: bool, check: Checks) -> None:
    """Phase 32a: each generated layout through the port's reader."""
    from pointnet2_tpu_torch.data import (
        ModelNetDataset,
        ModelNetH5Dataset,
        PartNormalDataset,
        ScannetDataset,
    )

    n_cls = 40 * sum(STANDIN_MODELNET)
    sets = [("ModelNetDataset (txt, normals)",
             ModelNetDataset(os.path.join(root, "txt"), batch_size=16,
                             npoints=N_POINT, split="train"),
             40 * STANDIN_MODELNET[0], (16, N_POINT, 6)),
            ("PartNormalDataset (v0_normal)",
             PartNormalDataset(os.path.join(root, "part"), npoints=PART_N,
                               split="trainval", batch_size=16),
             16 * sum(STANDIN_PART[:2]), (16, PART_N, 6)),
            ("ScannetDataset (pickles)",
             ScannetDataset(root=os.path.join(root, "scannet"),
                            npoints=SEM_N, split="train", batch_size=16),
             STANDIN_ROOMS[0], (16, SEM_N, 3))]
    if has_h5:
        sets.append(("ModelNetH5Dataset (HDF5)", ModelNetH5Dataset(
            os.path.join(root, "h5", "train_files.txt"), batch_size=16,
            npoints=N_POINT), 40 * STANDIN_MODELNET[0], (16, N_POINT, 3)))
    for what, ds, n, shape in sets:
        batch = next(ds.epoch())
        pts = batch["points"]
        check(len(ds) == n and pts.shape == shape
              and bool(np.isfinite(pts).all()) and batch["nvalid"] > 0,
              f"{what}: {len(ds)} items (want {n}), a batch of "
              f"{pts.shape}, finite")
    log(f"  ({n_cls} ModelNet shapes a layout; HDF5 "
        f"{'written and read' if has_h5 else 'skipped: no h5py'})")


def check_virtual_scan_cli(torch, check: Checks, root: str,
                           log_dir: str) -> dict:
    """Phase 32b: ``cli.train --model pointnet2_sem_seg --virtual_scan
    --dtype bfloat16`` on 32a's rooms (8192 points, B=8, 2 epochs, the
    chopped and whole-scene protocols every epoch), then ``cli.evaluate
    --ckpt best --out``, in this process, every counter from 0. Returns the
    launches."""
    from pointnet2_tpu_torch import ops
    from pointnet2_tpu_torch.cli import evaluate as cli_evaluate
    from pointnet2_tpu_torch.cli import train as cli_train

    run_dir = os.path.join(log_dir, "cli_vscan")
    out = os.path.join(log_dir, "cli_vscan.json")
    common = ["--model", SEM, "--data", os.path.join(root, "scannet"),
              "--num_point", str(SEM_N), "--batch_size", str(VSCAN_BATCH),
              "--log_dir", run_dir]
    for w in ops.KERNELS.values():
        w.launches = 0
    t0 = time.perf_counter()
    cli_train.main(common + ["--virtual_scan", "--dtype", "bfloat16",
                             "--max_epoch", str(VSCAN_EPOCHS),
                             "--eval_every", "1"])
    t1 = time.perf_counter()
    cli_evaluate.main(common + ["--ckpt", "best", "--out", out])
    t2 = time.perf_counter()
    counts = {k: w.launches for k, w in ops.KERNELS.items()}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(out) as f:
        record = json.load(f)
    train_rows = [r for r in rows if r["split"] == "train"]
    keys = {"point_accuracy", "point_accuracy_vox", "avg_class_accuracy",
            "avg_class_accuracy_vox", "calibrated_accuracy_vox",
            "calibrated_accuracy_point"}
    check([r["split"] for r in rows]
          == ["train", "eval_chopped", "eval_whole_scene"] * VSCAN_EPOCHS
          and all(np.isfinite(r["loss"]) for r in train_rows)
          and record["ckpt"] == "best" and record["model"] == SEM
          and set(record["metrics"]) == {"chopped", "whole_scene"}
          and all(set(m) == keys and all(np.isfinite(list(m.values())))
                  for m in record["metrics"].values()),
          f"cli.train --virtual_scan ({t1 - t0:.1f} s): train losses "
          f"{[round(r['loss'], 4) for r in train_rows]} at steps "
          f"{[r['step'] for r in train_rows]}; cli.evaluate --ckpt best "
          f"({t2 - t1:.1f} s): step {record['step']}, whole-scene "
          f"calibrated voxel accuracy "
          f"{record['metrics']['whole_scene']['calibrated_accuracy_vox']:.4f}")
    log(f"  launches in the virtual-scan journey: {counts}")
    check(all(counts[k] > 0 for k in ("fps", "ball_query", "gather_rows",
                                      "scatter_rows", "three_nn")),
          "the virtual-scan journey launched FPS, the ball query, the "
          "gather, the scatter and three_nn")
    return counts


def check_virtual_scan_step(torch, check: Checks, root: str,
                            log_dir: str) -> None:
    """Phase 32c: one bf16 sem_seg train step on a virtual-scan batch
    (B=16, 8192 points, the wdp input dropout) through the kernels and
    through the plain versions on the card, from the same weights and
    generator seed: loss and running statistics equal, gradients within
    phase 22's bf16 limits, and every scatter of the step bit for bit its
    plain version on CPU copies."""
    from pointnet2_tpu_torch.data import ScannetDatasetVirtualScan

    views = ScannetDatasetVirtualScan(root=os.path.join(root, "scannet"),
                                      npoints=SEM_N, split="train",
                                      batch_size=16, seed=SEED)
    batch = next(views.epoch())
    tol, median_tol = SEG_STEP_TOL["bfloat16"]
    with seg_trainer(torch, SEM, "bfloat16", os.path.join(
            log_dir, "vscan_step"), 1) as tr:
        dev_batch = tr._to_device(batch)
        zero = exact_zero_biases(tr.init_state().model)
        with capture_scatters() as calls:
            la, ga, ba, _ = one_step(torch, tr, dev_batch, "auto")
        lb, gb, bb, _ = one_step(torch, tr, dev_batch, "torch")
    stats_equal = all(torch.equal(ba[k], bb[k]) for k in ba)
    diffs = grad_differences(torch, ga, gb, zero)
    median = float(np.median([d for d, _ in diffs]))
    check(la == lb and np.isfinite(la) and stats_equal
          and diffs[0][0] <= tol and median <= median_tol,
          f"virtual-scan bf16 step ({len(views._all_views())} views, a "
          f"batch of {batch['nvalid']}): loss {la:.6f} (plain {lb:.6f}), "
          f"running statistics equal: {stats_equal}, gradient differences: "
          f"largest {diffs[0][0]:.2e} ({diffs[0][1]}), median "
          f"{median:.2e}; bounds {tol:g}, median {median_tol:g}")
    check_step_scatters(torch, "virtual-scan bf16", calls, check)


def check_standins(torch, check: Checks, log_dir: str) -> dict:
    """Phase 32: the generators, their layouts through the port's readers,
    the virtual-scan CLI journey and a virtual-scan step kernels vs plain.
    Returns 32b's launches."""
    log("phase 32: the procedural stand-ins and the virtual scan")
    t0 = time.perf_counter()
    root = os.path.join(log_dir, "standins")
    failed, has_h5 = generate_standins(root)
    check(not failed, f"the three generators' python -m entry points ran "
          f"({time.perf_counter() - t0:.1f} s){': ' if failed else ''}"
          f"{'; '.join(failed)}")
    if failed:
        return {k: 0 for k in REPLACES}
    check_standin_layouts(root, has_h5, check)
    counts = check_virtual_scan_cli(torch, check, root, log_dir)
    check_virtual_scan_step(torch, check, root, log_dir)
    torch.cuda.synchronize()
    log(f"  phase 32: {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 33: the rest of the surface
# ---------------------------------------------------------------------------

MESH_CASES = ((1, 20, "icosahedron"), (16, 2000, "random"))  # (B, T, mesh)
MESH_DRAWS, MESH_NPOINT = 8192, 1024
# phase 33b: (layer, spatial input, kernel), each with SAME and VALID at
# strides 1 and 2, 16 -> 32 channels, B=4
EXTRA_CASES = (("Conv1D", (256,), (5,)), ("Conv2D", (32, 32), (3, 3)),
               ("Conv3D", (12, 12, 12), (3, 3, 3)),
               ("Conv2DTranspose", (16, 16), (3, 3)))
# phase 33c's miniature data sets: shapes a class (ModelNet, txt layout),
# shapes a category and split (ShapeNet-part), rooms (ScanNet) and their
# sizes
REHEARSAL_MODELNET, REHEARSAL_PART = (1, 1), (1, 1, 1)
TRACED_GATHERS = 20  # phase 33f's launches inside profiling.trace
REHEARSAL_ROOMS = {"train": 2, "test": 1, "min_points": 20_000,
                   "max_points": 40_000}


def zero_launches() -> None:
    from pointnet2_tpu_torch import ops

    for w in ops.KERNELS.values():
        w.launches = 0


def read_launches() -> dict:
    from pointnet2_tpu_torch import ops

    return {k: w.launches for k, w in ops.KERNELS.items()}


def add_launches(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0) for k in REPLACES}


def mesh_input(torch, dev, B: int, T: int, kind: str,
               n_draws: int = MESH_DRAWS):
    """(triangles (B, T, 3, 3) on the card, uniforms (r, u, v) of n_draws
    a mesh drawn on the card from a seeded generator)."""
    from pointnet2_tpu_torch.examples.mesh_sampling_demo import icosahedron

    if kind == "icosahedron":
        tris = icosahedron()
    else:  # small random triangles scattered in the unit cube
        rng = np.random.default_rng(SEED + 33)
        centre = rng.uniform(-1, 1, (B, T, 1, 3))
        tris = (centre + 0.05 * rng.normal(size=(B, T, 3, 3))).astype(
            np.float32)
    g = torch.Generator(device=dev).manual_seed(SEED + T)
    draws = tuple(torch.rand((B, n_draws), generator=g, device=dev)
                  for _ in range(3))
    return torch.from_numpy(tris).to(dev), draws


def check_mesh(torch, dev, check: Checks) -> dict:
    """Phase 33a: ``sample_mesh`` through the kernels (the row gather of the
    corners and FPS) against the plain route on the same injected uniforms,
    at the demo's size and at B=16 meshes of 2000 triangles, 8192 draws ->
    1024: the dense draws and the reduced points exact, FPS's indices bit
    for bit; ``prob_sample`` on the card against the CPU (equal except
    within the cumsum gap, counted); host ms and launches a call. Returns
    the main-path launches."""
    from pointnet2_tpu_torch import config
    from pointnet2_tpu_torch.ops import (
        fps_kernel,
        prob_sample,
        sample_mesh,
        triangle_areas,
    )
    from pointnet2_tpu_torch.ops.sampling import fps_plain

    log("phase 33a: sample_mesh through the kernels vs the plain route, "
        "same uniforms")
    launches = {}
    for B, T, kind in MESH_CASES:
        tris, draws = mesh_input(torch, dev, B, T, kind)
        zero_launches()
        dense = sample_mesh(tris, MESH_DRAWS, uniforms=draws)
        reduced = sample_mesh(tris, MESH_DRAWS, npoint=MESH_NPOINT,
                              uniforms=draws)
        torch.cuda.synchronize()
        got = read_launches()
        launches = add_launches(launches, got)
        with config.default_impl("torch"):
            dense_p = sample_mesh(tris, MESH_DRAWS, uniforms=draws)
            reduced_p = sample_mesh(tris, MESH_DRAWS, npoint=MESH_NPOINT,
                                    uniforms=draws)
        idx_k = fps_kernel(dense, MESH_NPOINT)
        idx_p = fps_plain(dense, MESH_NPOINT)
        ms = host_ms(torch, lambda: sample_mesh(
            tris, MESH_DRAWS, npoint=MESH_NPOINT, uniforms=draws).cpu(), 10)
        check(got["fps"] == 1 and got["gather_rows"] == 3
              and torch.equal(dense, dense_p) and torch.equal(idx_k, idx_p)
              and torch.equal(reduced, reduced_p)
              and bool(torch.isfinite(reduced).all())
              and reduced.shape == (B, MESH_NPOINT, 3),
              f"{kind} B={B} T={T}, {MESH_DRAWS} -> {MESH_NPOINT}: dense "
              f"draws exact, FPS indices bit for bit, reduced points exact; "
              f"launches {{fps: {got['fps']}, gather_rows: "
              f"{got['gather_rows']}}} (two calls); host {ms:.3f} ms a "
              f"reducing call")
    # prob_sample: the card's cumsum against the CPU's on the same weights
    w = triangle_areas(tris).cpu()
    r = draws[0].cpu()
    got, want = prob_sample(w.to(dev), r.to(dev)).cpu(), prob_sample(w, r)
    cs_d = torch.cumsum(w.to(dev), 1).cpu().double()
    cs_h = torch.cumsum(w, 1).double()
    gap = float((cs_d - cs_h).abs().max()
                + (cs_d[:, -1] - cs_h[:, -1]).abs().max())
    diff = (got != want).nonzero().tolist()
    q = r.double() * cs_h[:, -1:]
    within = all(abs(int(got[b, m]) - int(want[b, m])) == 1
                 and abs(float(q[b, m] - cs_h[b, min(int(got[b, m]),
                                                      int(want[b, m]))]))
                 <= gap + 1e-6 * float(cs_h[b, -1]) for b, m in diff)
    check(within and len(diff) <= max(2, got.numel() // 500),
          f"prob_sample on the card vs the CPU ({tuple(w.shape)} weights, "
          f"{tuple(r.shape)} draws): {len(diff)} indices differ, each by one "
          f"within the cumsums' gap {gap:.3e}")
    return launches


def check_extras(torch, dev, check: Checks) -> None:
    """Phase 33b: the conv/pool layer zoo on the card against the CPU, f32
    with TF32 off (config.disable_tf32): every conv kind, SAME and VALID,
    strides 1 and 2, in eval and train mode with BN, within 1e-5 of max|y|;
    the max pools equal, the average pools within 1e-5 of max|y|."""
    import copy

    from pointnet2_tpu_torch import config
    from pointnet2_tpu_torch.nn import extras

    log("phase 33b: nn.extras on the card vs the CPU, f32 (TF32 off)")
    config.disable_tf32()
    g = torch.Generator().manual_seed(SEED + 34)
    worst = {}
    for name, spatial, kernel in EXTRA_CASES:
        x = torch.randn((4, *spatial, 16), generator=g)
        for padding in ("SAME", "VALID"):
            for s in (1, 2):
                layer = getattr(extras, name)(16, 32, kernel,
                                              (s,) * len(kernel), padding,
                                              bn=True)
                layer.reset_parameters(g)
                card = copy.deepcopy(layer).to(dev)
                for mode in ("eval", "train"):
                    getattr(layer, mode)()
                    getattr(card, mode)()
                    with torch.no_grad():
                        want = layer(x, 0.9)
                        got = card(x.to(dev), 0.9).cpu()
                    err = float((got - want).abs().max()
                                / want.abs().max())
                    key = f"{name} {padding} s={s} {mode}"
                    worst[key] = err
                    if got.shape != want.shape or not err <= 1e-5:
                        check(False, f"{key}: shape {tuple(got.shape)}, "
                              f"relative error {err:.2e}")
    check(max(worst.values()) <= 1e-5,
          f"{len(worst)} conv cases on the card within 1e-5 of max|y| of "
          f"the CPU's: largest {max(worst.values()):.2e} "
          f"({max(worst, key=worst.get)})")
    x = torch.randn((4, 15, 16, 17, 8), generator=g)
    errs = []
    for nd, xs in ((2, x[:, 0]), (3, x)):
        for padding in ("SAME", "VALID"):
            args = ((3,) * nd, (2,) * nd, padding)
            mx = getattr(extras, f"max_pool{nd}d")
            av = getattr(extras, f"avg_pool{nd}d")
            errs.append(torch.equal(mx(xs.to(dev), *args).cpu(),
                                    mx(xs, *args)))
            want = av(xs, *args)
            errs.append(float((av(xs.to(dev), *args).cpu() - want).abs().max()
                              / want.abs().max()) <= 1e-5)
    check(all(errs), "max pools 2d/3d SAME/VALID equal on the card and the "
          "CPU, average pools within 1e-5 of max|y|")


def rehearsal_data(root: str) -> dict:
    """Phase 33c: the three miniature data sets in their real layouts
    (ModelNet40 txt with normals: the card's machine has no h5py;
    ShapeNet-part v0_normal; ScanNet pickles), each zipped with one wrapper
    directory as downloaded. Returns {dataset: zip path}."""
    from pointnet2_tpu_torch.data import procedural_modelnet as mn
    from pointnet2_tpu_torch.data import procedural_scannet as sc
    from pointnet2_tpu_torch.data import procedural_shapenet_part as sp

    raws = {"modelnet40_normal": os.path.join(
                root, "raw", "modelnet40_normal_resampled"),
            "shapenet_part": os.path.join(
                root, "raw",
                "shapenetcore_partanno_segmentation_benchmark_v0_normal"),
            "scannet": os.path.join(root, "raw", "scannet_data_pointnet2")}
    mn.generate_txt(raws["modelnet40_normal"],
                    train_per_class=REHEARSAL_MODELNET[0],
                    test_per_class=REHEARSAL_MODELNET[1], npoints=N_POINT,
                    seed=SEED)
    tr, va, te = REHEARSAL_PART
    sp.generate(raws["shapenet_part"], train_per_class=tr, val_per_class=va,
                test_per_class=te, npoints=PART_N, seed=SEED)
    sc.generate(raws["scannet"], seed=SEED, **REHEARSAL_ROOMS)
    zips = {}
    for name, raw in raws.items():
        zips[name] = shutil.make_archive(
            os.path.join(root, f"{name}_download"), "zip",
            root_dir=os.path.dirname(raw), base_dir=os.path.basename(raw))
        shutil.rmtree(raw)
    return zips


def check_rehearsal(torch, check: Checks, log_dir: str) -> tuple:
    """Phase 33c: the parity-day path on the card: each miniature zip
    through ``data.ingest``, then ``cli.train`` (1 epoch) and
    ``cli.evaluate --out`` with ``--device cuda``: cls_ssg ``--normal`` on
    the ModelNet txt layout (1024 points, B=16, 2 votes),
    part_seg_msg_one_hot on ShapeNet-part (2048 points, B=16, 2 votes),
    sem_seg on ScanNet (8192 points, B=8, the chopped and whole-scene
    protocols). Returns (the launches, {model: (data root, run dir,
    flags)})."""
    from pointnet2_tpu_torch.cli import evaluate as cli_evaluate
    from pointnet2_tpu_torch.cli import train as cli_train
    from pointnet2_tpu_torch.data import ingest

    log("phase 33c: the dress rehearsal on the card: ingest, cli.train, "
        "cli.evaluate")
    root = os.path.join(log_dir, "rehearsal")
    t0 = time.perf_counter()
    zips = rehearsal_data(root)
    log(f"  wrote the three miniature zips in {time.perf_counter() - t0:.1f}"
        " s")
    try:
        import h5py  # noqa: F401
        h5 = "h5py is installed here"
    except ImportError:
        try:
            ingest.validate_modelnet40_h5(root, log=lambda m: None)
            h5 = "the H5 validator ran without h5py"
        except ImportError as e:
            h5 = f"the H5 validator raises here: {e}"
    log(f"  ModelNet40 HDF5 layout: validated on the CPU only "
        f"(tests/test_torch_dress_rehearsal.py); {h5}")
    cases = (
        ("modelnet40_normal", "modelnet40_normal_resampled", CLS_SSG,
         ["--normal", "--num_point", str(N_POINT), "--batch_size", "16"],
         ["--num_votes", "2"], ("accuracy", "avg_class_accuracy")),
        ("shapenet_part", "shapenet_part", PART_MSG,
         ["--num_point", str(PART_N), "--batch_size", "16"],
         ["--num_votes", "2"], ("accuracy", "instance_miou",
                                "category_miou")),
        ("scannet", "scannet_pickles", SEM,
         ["--num_point", str(SEM_N), "--batch_size", "8"], [],
         ("chopped", "whole_scene")))
    zero_launches()
    runs = {}
    for dataset, dest_name, model, flags, eval_flags, keys in cases:
        dest = os.path.join(root, "data", dest_name)
        run_dir = os.path.join(root, f"run_{model}")
        out = os.path.join(root, f"{model}.json")
        common = ["--model", model, "--data", dest, "--log_dir", run_dir,
                  "--device", "cuda", *flags]
        t0 = time.perf_counter()
        ingest.main(["--dataset", dataset, "--src", zips[dataset], "--dest",
                     dest])
        t1 = time.perf_counter()
        cli_train.main(common + ["--max_epoch", "1"])
        t2 = time.perf_counter()
        cli_evaluate.main(common + eval_flags + ["--out", out])
        t3 = time.perf_counter()
        with open(out) as f:
            record = json.load(f)
        metrics = record["metrics"]
        flat = (metrics if model != SEM else
                {f"{k}.{m}": v for k, d in metrics.items()
                 for m, v in d.items()})
        scalars = {k: v for k, v in flat.items() if isinstance(v, float)}
        check(all(k in metrics for k in keys) and record["step"] >= 1
              and os.path.isfile(os.path.join(run_dir, "ckpt", "state.pt"))
              and all(np.isfinite(v) for v in scalars.values()),
              f"{dataset} -> {model}: ingest {t1 - t0:.1f} s, cli.train "
              f"{t2 - t1:.1f} s ({record['step']} steps), cli.evaluate "
              f"{t3 - t2:.1f} s; "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(scalars.items())))
        runs[model] = (dest, run_dir, flags)
    counts = read_launches()
    log(f"  launches in the dress rehearsal: {counts}")
    check(all(counts[k] > 0 for k in ("fps", "ball_query", "gather_rows",
                                      "scatter_rows", "three_nn")),
          "the rehearsal launched FPS, the ball query, the gather, the "
          "scatter and three_nn (the MSG layers query radius by radius by "
          "default, as in JAX)")
    return counts, runs


def png_ok(path: str) -> tuple:
    """(decodes with the standard-library reader, share of pixels off the
    background) of a PNG the port wrote."""
    from pointnet2_tpu_torch.utils.png import read_png

    img = read_png(path)
    lit = float((img.reshape(img.shape[0], img.shape[1], -1).max(-1)
                 > 0).mean())
    return img.ndim in (2, 3), lit


def check_visualize(torch, check: Checks, runs: dict, out_dir: str) -> dict:
    """Phase 33d: ``cli.visualize`` on 33c's classifier and part-segmenter
    checkpoints, on the card: the native renderer built by g++ and loaded
    (not the numpy fallback), the PNGs decode and are not blank. Returns
    the launches."""
    from pointnet2_tpu_torch.cli import visualize
    from pointnet2_tpu_torch.viz import viewer

    log("phase 33d: cli.visualize on the rehearsal's checkpoints")
    zero_launches()
    written = []
    for model in (CLS_SSG, PART_MSG):
        data, run_dir, flags = runs[model]
        t0 = time.perf_counter()
        paths = visualize.main(["--model", model, "--data", data,
                                "--log_dir", run_dir, "--num_samples", "2",
                                "--canvas", "400", "--out",
                                os.path.join(out_dir, f"viz_{model}"),
                                "--device", "cuda", *flags])
        with open(os.path.join(run_dir, "log_train.txt")) as f:
            restored = "restored ckpt at step" in f.read()
        stats = [png_ok(p) for p in paths]
        check(restored and len(paths) == (2 if model == CLS_SSG else 4)
              and all(ok and lit > 0.005 for ok, lit in stats),
              f"{model}: restored its checkpoint, wrote {len(paths)} PNGs "
              f"({time.perf_counter() - t0:.1f} s), each decodes, lit "
              f"pixels {min(s[1] for s in stats):.3f}-"
              f"{max(s[1] for s in stats):.3f}")
        written += paths
    lib = viewer.native_library()
    check(lib is not None and os.path.isfile(lib)
          and os.path.dirname(lib) == str(viewer.BUILD_DIR),
          f"the native ball renderer was built by g++ "
          f"({' '.join(viewer.GXX_FLAGS)}) and loaded: {lib} "
          f"{viewer.build_error()}")
    return read_launches()


def check_demos(torch, check: Checks, out_dir: str) -> dict:
    """Phase 33e: the three demos with ``--device cuda``, their PNGs under
    ``out_dir``: the mesh demo's reduced cloud the FPS subset of its dense
    one, the interpolation demo equal to its CPU run within 1e-5, the
    scene demo at its full size (a room generated for 80-100k points,
    sem_seg at 8192 points a block, random weights): every point labelled,
    votes, wall time. Returns the launches."""
    from pointnet2_tpu_torch.examples import (
        interpolation_demo,
        mesh_sampling_demo,
        scene_inference_demo,
    )
    from pointnet2_tpu_torch.ops import fps_kernel

    log("phase 33e: the three demos on the card")
    zero_launches()
    t0 = time.perf_counter()
    mesh = mesh_sampling_demo.main(["--out", os.path.join(out_dir, "mesh"),
                                    "--device", "cuda"])
    t1 = time.perf_counter()
    interp = interpolation_demo.main([
        "--out", os.path.join(out_dir, "interp"), "--device", "cuda"])
    t2 = time.perf_counter()
    scene = scene_inference_demo.main([
        "--out", os.path.join(out_dir, "scene_pred.png"), "--device",
        "cuda"])
    t3 = time.perf_counter()
    counts = read_launches()
    dense = torch.from_numpy(mesh["dense"]).cuda()
    idx = fps_kernel(dense, MESH_NPOINT).cpu().numpy()
    check(mesh["reduced"].shape == (1, MESH_NPOINT, 3)
          and np.array_equal(mesh["reduced"][0], mesh["dense"][0, idx[0]])
          and all(png_ok(p)[1] > 0.005 for p in mesh["paths"]),
          f"mesh demo ({t1 - t0:.2f} s): {mesh['dense'].shape} -> "
          f"{mesh['reduced'].shape}, the reduced cloud is the dense one's "
          "FPS subset, PNGs decode, not blank")
    cpu = interpolation_demo.main([
        "--out", os.path.join(out_dir, "interp_cpu"), "--device", "cpu"])
    err = float(np.abs(interp["dense_color"] - cpu["dense_color"]).max())
    check(err <= 1e-5 and all(png_ok(p)[1] > 0.005 for p in interp["paths"]),
          f"interpolation demo ({t2 - t1:.2f} s): dense colours on the card "
          f"vs the CPU max abs diff {err:.2e}, PNGs decode, not blank")
    pred = scene["pred"]
    n = len(scene["points"])
    check(n >= SEM_N and pred["labels"].shape == (n,)
          and int(pred["votes"].min()) >= 1
          and bool(np.isfinite(pred["logits"]).all())
          and png_ok(os.path.join(out_dir, "scene_pred.png"))[1] > 0.005,
          f"scene demo ({t3 - t2:.2f} s): {n} points, every one labelled, "
          f"votes {int(pred['votes'].min())}-{int(pred['votes'].max())}, "
          f"predict_scene {scene['seconds'] * 1e3:.1f} ms (host clock, "
          f"first call), annotated accuracy {scene['accuracy']:.4f} "
          "(random weights)")
    log(f"  launches in the demos: {counts}")
    check(all(counts[k] > 0 for k in ("fps", "ball_query", "gather_rows",
                                      "three_nn")),
          "the demos launched FPS, the ball query, the gather and three_nn")
    return counts


# phase 33f's trace in a fresh process: the row gather at phase 5's bf16
# shape, TRACED_GATHERS launches inside profiling.trace
TRACE_SCRIPT = """\
import json, sys
import torch
sys.path.insert(0, {root!r})
from pointnet2_tpu_torch.ops import grouping
from pointnet2_tpu_torch.utils import profiling
g = torch.Generator(device="cuda").manual_seed(0)
pts = torch.randn((16, 1024, 64), generator=g, device="cuda").bfloat16()
ix = torch.randint(0, 1024, (16, 16384), generator=g, device="cuda",
                   dtype=torch.int32)
grouping.gather_rows_kernel(pts, ix)
with profiling.trace({tdir!r}) as prof:
    for _ in range({n}):
        grouping.gather_rows_kernel(pts, ix)
print(json.dumps(sum(getattr(e, "self_device_time_total", 0)
                     for e in prof.key_averages()
                     if "gather_rows_kernel" in e.key)))
"""


def traced_gathers(tdir: str) -> list:
    """The names of ``gather_rows_kernel`` events in tdir/trace.json."""
    with open(os.path.join(tdir, "trace.json")) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    return [n for n in names if "gather_rows_kernel" in n]


def check_profiling(torch, dev, gpu: str, check: Checks,
                    out_dir: str) -> None:
    """Phase 33f: ``utils.profiling`` on the card: ``time_op_loop`` of the
    row gather at phase 5's bf16 shape beside phase 5's CUDA-event timing
    of the same launch, and ``trace`` writing a Chrome trace that names
    every launch of the gather's kernel in a fresh process (checked); and
    (logged) in this process after the earlier phases, followed by a
    second window (tools/profiler_probe.window): late in a full run the
    profiler loses some or all of a window's kernels, erratically, which
    no history of tools/profiler_probe.py reproduces in a fresh
    process."""
    from pointnet2_tpu_torch.ops import grouping
    from pointnet2_tpu_torch.tools.profiler_probe import PROBE, window
    from pointnet2_tpu_torch.utils import profiling

    log(f"phase 33f: utils.profiling on {gpu}")
    lv = kernel_inputs(torch, dev, 16)[0]
    pts = lv["lifted"].to(torch.bfloat16)
    ix = lv["idx"].reshape(16, -1)
    out = torch.empty((16, ix.shape[1], pts.shape[2]), dtype=pts.dtype,
                      device=dev)
    loop_ms = profiling.time_op_loop(
        lambda p: grouping.launch_gather_rows(p, ix, out), pts,
        iters=100) * 1e3
    ev_ms = event_ms(torch, lambda: grouping.launch_gather_rows(pts, ix, out),
                     100, prefill=True)
    fn_ms = profiling.time_fn(lambda: grouping.gather_rows_kernel(pts, ix),
                              iters=20) * 1e3
    check(0 < loop_ms < 10 * ev_ms + 0.05,
          f"gather_rows {tuple(pts.shape)} bf16 by {tuple(ix.shape)}: "
          f"time_op_loop {loop_ms:.6f} ms a launch, phase 5's CUDA events "
          f"(queue pre-filled) {ev_ms:.6f} ms, time_fn {fn_ms:.6f} ms a "
          "synchronised call (host clock)")
    tdir = os.path.join(out_dir, "trace_here")
    with profiling.trace(tdir):
        for _ in range(TRACED_GATHERS):
            grouping.gather_rows_kernel(pts, ix)
    again = window(torch, lambda: grouping.gather_rows_kernel(pts, ix),
                   "plain")
    log(f"  trace in this process: {len(traced_gathers(tdir))} of "
        f"{TRACED_GATHERS} gather launches as kernel events; a second "
        f"window right after: {again} of {PROBE}")
    tdir = os.path.join(out_dir, "trace")
    script = TRACE_SCRIPT.format(
        root=os.path.dirname(os.path.abspath(__file__)), tdir=tdir,
        n=TRACED_GATHERS)
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True,
                          timeout=SPAWN_TIMEOUT)
    hits = traced_gathers(tdir) if proc.returncode == 0 else []
    device_us = float(proc.stdout.strip() or 0) if hits else 0.0
    check(len(hits) == TRACED_GATHERS,
          f"trace in a fresh process wrote {tdir}/trace.json naming "
          f"{hits[0][:60] if hits else 'no gather kernel'}, {len(hits)} of "
          f"{TRACED_GATHERS} launches ({device_us / TRACED_GATHERS:.1f} us "
          f"a launch by key_averages){proc.stderr[-500:] if not hits else ''}")


def check_surface(torch, dev, gpu: str, check: Checks, log_dir: str) -> dict:
    """Phase 33: mesh sampling, the layer zoo, the dress rehearsal,
    cli.visualize, the demos and the profiling helpers on the card. Returns
    the main-path launches of 33a, 33c, 33d and 33e."""
    log("phase 33: the rest of the surface")
    t0 = time.perf_counter()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out", "phase33")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    counts = check_mesh(torch, dev, check)
    check_extras(torch, dev, check)
    rehearsal, runs = check_rehearsal(torch, check, log_dir)
    counts = add_launches(counts, rehearsal)
    counts = add_launches(counts, check_visualize(torch, check, runs,
                                                  out_dir))
    counts = add_launches(counts, check_demos(torch, check, out_dir))
    check_profiling(torch, dev, gpu, check, out_dir)
    torch.cuda.synchronize()
    log(f"  phase 33: {time.perf_counter() - t0:.1f} s, launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 34: FPS at any cloud size
# ---------------------------------------------------------------------------

# (B, N, npoint, what) of phase 34's random clouds; the rooms, the tied
# clouds and the identical points follow them
FPS_ANY = ((16, 16384, 1024, "the CTA route's edge"),
           (1, 16385, 64, "the cluster route's first size"),
           (4, 50000, 1024, "four clouds of 50000"),
           (1, 262144, 512, "the registers' edge"),
           (1, 262145, 64, "the scratch route's first size"),
           (1, 1_000_000, 128, "a lidar-sized cloud"))
FPS_ROOMS, FPS_ROOM_NPOINT = 2, 8192  # whole generated ScanNet rooms
FPS_MESH = (16, 2000, 100_000, 10_000)  # meshes, triangles, draws, points
FPS_PHASE_S = 60.0  # phase 34's time limit, s, after the build
GRID_Y_CLOUDS = 65537  # three_nn's and the scatter's B past gridDim.y


def fps_any_case(torch, xyz, npoint: int, what: str, seg_us: float,
                 check: Checks, errs: dict) -> tuple:
    """Phase 34a-b for one input: ``farthest_point_sample`` through the
    kernel (launches counted) bit for bit ``fps_plain`` on the card, then
    the launch's time (CUDA events, queue pre-filled), µs a step beside
    sem_seg SA1's ``seg_us``, the plain version's time and the operations
    bound. Returns (the call's launches, its indices)."""
    from pointnet2_tpu_torch import ops
    from pointnet2_tpu_torch.ops import sampling

    B, N, _ = xyz.shape
    route, c = sampling.fps_route(N)
    zero_launches()
    got = ops.farthest_point_sample(xyz, npoint)
    torch.cuda.synchronize()
    counts = read_launches()
    want = sampling.fps_plain(xyz, npoint)
    errs["fps"] = max(errs["fps"], int((got - want).abs().max()))
    out, scratch = torch.empty_like(got), sampling.fps_scratch(xyz)
    ms = event_ms(torch, lambda: sampling.launch_fps(xyz, out, scratch), 3,
                  prefill=True)
    plain = event_ms(torch, lambda: sampling.fps_plain(xyz, npoint), 1)
    bound = fps_bound(B, N, npoint)
    us = ms * 1e3 / max(npoint - 1, 1)
    check(torch.equal(got, want) and torch.equal(out, want)
          and counts["fps"] == 1,
          f"fps {what} {tuple(xyz.shape)} -> {npoint}: route {route}, C={c},"
          f" bit for bit fps_plain (the call and the timed launches), "
          f"{counts['fps']} launch")
    log(f"   kernel {ms:.6f} ms, {us:.4f} us a step ({us / seg_us:.2f}x "
        f"sem_seg SA1's {seg_us:.4f}), plain {plain:.6f} ms, bound "
        f"{bound[0]:.6f} ms ({bound[1]}, {bound[0] / ms:.2%} of the kernel)")
    return counts, got


def fps_rooms(torch, dev) -> list:
    """Phase 34a's whole rooms: FPS_ROOMS clouds of make_scene's 60-180k
    points on the card, each (1, N, 3), ragged."""
    from pointnet2_tpu_torch.data.procedural_scannet import make_scene

    rng = np.random.default_rng(SEED + 34)
    return [torch.from_numpy(make_scene(rng)[0][None]).to(dev)
            for _ in range(FPS_ROOMS)]


def fps_tied(torch, dev) -> list:
    """Phase 34a's tied clouds: (cloud, npoint, what, the expected second
    pick or None): a 64^3 integer lattice (262144 points, C=16), whose
    equal distances straddle every slice; one far point copied into the
    fourth, second and third slice of a 50000-point cloud (C=4, S=12500),
    whose lowest copy, 13000, must be the second pick; and 40000 identical
    points, every pick 0."""
    g = np.stack(np.meshgrid(*[np.arange(64.0)] * 3, indexing="ij"),
                 -1).reshape(1, -1, 3).astype(np.float32)
    far = np.random.default_rng(SEED + 35).random((1, 50000, 3)).astype(
        np.float32)
    far[0, [45000, 13000, 26000]] = 5.0
    same = np.full((1, 40000, 3), -0.5, np.float32)
    return [(torch.from_numpy(g).to(dev), 256, "a 64^3 lattice", None),
            (torch.from_numpy(far).to(dev), 128,
             "a far point copied across slices", 13000),
            (torch.from_numpy(same).to(dev), 64, "40000 identical points", 0)]


def check_fps_any_size(torch, dev, gpu: str, check: Checks,
                       errs: dict) -> dict:
    """Phase 34: FPS at any cloud size on the card. (a-b) every FPS_ANY
    shape, two whole generated rooms thinned to 8192 points, the tied
    clouds and the identical points through ``farthest_point_sample``,
    bit for bit ``fps_plain``, one launch a call, each timed (µs a step
    beside sem_seg SA1's, timed first); (c) ``sample_mesh`` with 100000
    draws -> 10000 points on 16 meshes through the kernels and the plain
    route, exact; (d) three_nn and the scatter-add at B = 65537, bit for
    bit their plain versions. Logs ptxas -v of csrc/fps.cu first. Returns
    the launches of the calls through the public ops."""
    from pointnet2_tpu_torch import config, ops
    from pointnet2_tpu_torch.ops import _build, sampling, sample_mesh
    from pointnet2_tpu_torch.ops.interpolate import three_nn_plain

    log(f"phase 34: FPS at any cloud size on {gpu}")
    log("  ptxas -v of csrc/fps.cu (registers, shared memory, stack frame, "
        "spills):")
    for line in _build.ptxas_report("fps"):
        log(f"   {line}")
    t0 = time.perf_counter()
    counts = dict.fromkeys(REPLACES, 0)
    Bs, n, npoint = FPS_SEG
    xyz = fps_seg_input(torch, dev)
    out = torch.empty((Bs, npoint), dtype=torch.int32, device=dev)
    ms = event_ms(torch, lambda: sampling.launch_fps(xyz, out), 10,
                  prefill=True)
    seg_us = ms * 1e3 / (npoint - 1)
    log(f"  fps sem_seg SA1 ({Bs},{n},3)->{npoint} (the CTA route): kernel "
        f"{ms:.6f} ms, {seg_us:.4f} us a step")
    cases = [(torch.from_numpy(make_clouds(B, N, SEED + N)).to(dev), m, what)
             for B, N, m, what in FPS_ANY]
    cases += [(room, FPS_ROOM_NPOINT, f"a whole room of {room.shape[1]}")
              for room in fps_rooms(torch, dev)]
    for xyz, m, what in cases:
        got, _ = fps_any_case(torch, xyz, m, what, seg_us, check, errs)
        counts = add_launches(counts, got)
    del cases
    for xyz, m, what, second in fps_tied(torch, dev):
        got, idx = fps_any_case(torch, xyz, m, what, seg_us, check, errs)
        counts = add_launches(counts, got)
        if second is not None:
            check(int(idx[0, 1]) == second and (second != 0 or not idx.any()),
                  f"fps {what}: the second pick is {int(idx[0, 1])}"
                  f"{', every pick 0' if second == 0 else ''}")

    B, T, draws_n, m = FPS_MESH
    tris, draws = mesh_input(torch, dev, B, T, "random", draws_n)
    zero_launches()
    reduced = sample_mesh(tris, draws_n, npoint=m, uniforms=draws)
    torch.cuda.synchronize()
    got = read_launches()
    counts = add_launches(counts, got)
    with config.default_impl("torch"):
        reduced_p = sample_mesh(tris, draws_n, npoint=m, uniforms=draws)
    ms = host_ms(torch, lambda: sample_mesh(tris, draws_n, npoint=m,
                                            uniforms=draws), 3, warmup=1)
    check(torch.equal(reduced, reduced_p) and reduced.shape == (B, m, 3)
          and bool(torch.isfinite(reduced).all()) and got["fps"] == 1
          and got["gather_rows"] == 2,
          f"sample_mesh {B} meshes of {T} triangles, {draws_n} draws -> {m} "
          f"(FPS route {sampling.fps_route(draws_n)}): through the kernels "
          f"exact against the plain route; launches {{fps: {got['fps']}, "
          f"gather_rows: {got['gather_rows']}}}; host {ms:.3f} ms a call")

    gen = torch.Generator(device=dev).manual_seed(SEED + 36)
    xyz1 = torch.rand((GRID_Y_CLOUDS, 4, 3), generator=gen, device=dev)
    xyz2 = torch.rand((GRID_Y_CLOUDS, 5, 3), generator=gen, device=dev)
    g = torch.randn((GRID_Y_CLOUDS, 8, 3), generator=gen, device=dev)
    idx = torch.randint(-1, 6, (GRID_Y_CLOUDS, 8), generator=gen,
                        device=dev, dtype=torch.int32)
    zero_launches()
    dist, nn_idx = ops.three_nn(xyz1, xyz2)
    summed = ops.scatter_rows(g, idx, 5)
    torch.cuda.synchronize()
    got = read_launches()
    counts = add_launches(counts, got)
    wdist, widx = three_nn_plain(xyz1, xyz2)
    same, err = scatter_same(torch, summed, g, idx, 5)
    check(torch.equal(nn_idx, widx)
          and torch.equal(dist.view(torch.int32), wdist.view(torch.int32))
          and same and got["three_nn"] == 1 and got["scatter_rows"] == 1,
          f"B={GRID_Y_CLOUDS} clouds (past gridDim.y's 65535): three_nn "
          f"{tuple(xyz1.shape)} by {tuple(xyz2.shape)} and scatter_rows "
          f"{tuple(g.shape)} -> 5 rows bit for bit their plain versions "
          f"(scatter max abs diff {err:.3e}), one launch each")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(dt < FPS_PHASE_S, f"phase 34 took {dt:.1f} s after the build and "
          f"ptxas (limit {FPS_PHASE_S:g} s); launches {counts}")
    return counts


def check_tensor_cores(_build, check: Checks) -> None:
    """Phase 1: in the built fused_mlp library's SASS, the bf16 dense
    pass's product and the bf16 dense backward's two are tensor-core
    instructions (HMMA or HGMMA) and the f32 ones, on the CUDA cores
    without TF32, are not."""
    counts = _build.sass_mma_counts("fused_mlp")
    for kernel in (*MMA_KERNELS, *FMA_KERNELS):
        found = {k: n for k, n in counts.items() if kernel in k}
        mma = kernel in MMA_KERNELS
        ok = bool(found) and all((n > 0) == mma for n in found.values())
        check(ok, f"SASS of {kernel}: {sum(found.values())} HMMA/HGMMA "
                  f"instructions in {len(found)} instantiation(s), "
                  f"{'on' if mma else 'off'} the tensor cores")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from pointnet2_tpu_torch import Predictor, config, ops
        from pointnet2_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gpu = gpu_line()
    log(f"gpu: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    check = Checks()

    log("phase 1: build the kernels with nvcc")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"  built {len(_build.SOURCES)} sources ({', '.join(_build.SOURCES)})"
        f" in {time.perf_counter() - t0:.2f} s into {_build.BUILD_DIR.name}/")
    # the Trainer's logs, in the checkout's git-ignored log/ directory
    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "log", "chip_smoke_train")
    shutil.rmtree(log_dir, ignore_errors=True)
    if sys.argv[1:] == ["--phase", "31"]:
        check_scale_out(torch, check, log_dir, gpu)
        return finish(torch, check, t_start, gpu, None)
    if sys.argv[1:] == ["--phase", "32"]:
        check_standins(torch, check, log_dir)
        return finish(torch, check, t_start, gpu, None)
    if sys.argv[1:] == ["--phase", "33"]:
        check_surface(torch, dev, gpu, check, log_dir)
        return finish(torch, check, t_start, gpu, None)
    if sys.argv[1:] == ["--phase", "34"]:
        check_fps_any_size(torch, dev, gpu, check, {"fps": 0})
        return finish(torch, check, t_start, gpu, None)
    for src in ("ball_query", "scatter", "three_nn", "fused_mlp"):
        log(f"  ptxas -v of csrc/{src}.cu (registers, shared memory, "
            "stack frame, spills):")
        report = _build.ptxas_report(src)
        for line in report:
            log(f"   {line}")
        if src == "ball_query":
            clean = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill"
            check(len(report) == 10 and all(clean in ln for ln in report),
                  "csrc/ball_query.cu: rows 2-3's two instances and row 4's "
                  "eight, no stack frame (local memory) and no spills")
    check_tensor_cores(_build, check)

    errs = {"fps": 0, "ball_query": 0, "ball_query_group_xyz": 0,
            "ball_query_multi": 0, "gather_rows": 0.0, "scatter_rows": 0.0,
            "three_nn": 0, "fused_dense": 0.0, "fused_pool": 0.0,
            "fused_affine": 0.0, "fused_top_stats": 0.0,
            "fused_dense_bwd": 0.0, "fused_first_bwd": 0.0}
    t0 = time.perf_counter()
    room = make_room(100_000, SEED + 10)
    blocks = room_blocks(room, 100, SEED + 11)
    parts = make_clouds(64, PART_N, SEED + 12, normals=True)
    log(f"  generated a room of {len(room)} points, 100 blocks of {SEM_N} "
        f"and 64 part clouds of {PART_N} in {time.perf_counter() - t0:.2f} s")
    for B in (16, 768):
        check_kernels(torch, dev, B, check, errs)
    check_fps_seg(torch, dev, check, errs)
    check_ball_query_seg(torch, dev, blocks, check, errs)

    log("phase 3: serve pointnet2_cls_ssg at N=1024 through the kernels")
    sd = random_state_dict(torch, SEED)
    predictors = {
        "bf16": Predictor("pointnet2_cls_ssg", sd, dtype=torch.bfloat16),
        "f32": Predictor("pointnet2_cls_ssg", sd, dtype=torch.float32),
    }
    clouds = make_clouds(100, N_POINT, SEED + 1)
    for w in ops.KERNELS.values():
        w.launches = 0
    run = drive_main_path(torch, predictors, clouds)
    launches = {k: w.launches for k, w in ops.KERNELS.items()}
    # model calls: one per chunk of the largest bucket (64), in bf16 and
    # f32, plus one for the 12 votes
    n_fwd = 2 * sum(-(-b // 64) for b in (1, 16, 64, 100)) + 1
    log(f"  launches in the main-path run ({n_fwd} forwards): {launches}")
    for name, per_fwd in (("fps", 2), ("ball_query", 2), ("gather_rows", 4)):
        check(launches[name] == per_fwd * n_fwd,
              f"{name} launched {per_fwd} times per forward")
    check(launches["scatter_rows"] == 0,
          "scatter_rows launched 0 times in serving (no backward)")

    # Kernel path vs the same requests on the plain versions, same card:
    # indices are bit-identical and gathers exact, so the two runs share
    # every input of every later op; expected difference 0, bound 1e-5 of
    # the logits' range for a cuBLAS algorithm choice that might differ.
    with config.default_impl("torch"):
        for w in ops.KERNELS.values():
            w.launches = 0
        plain = drive_main_path(torch, predictors, clouds)
        check(all(w.launches == 0 for w in ops.KERNELS.values()),
              "the plain run launched no kernel")
    for key, got in run.items():
        want = plain[key]
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        shape_ok = got.shape == ((16, NUM_CLASSES) if key == "votes" else
                                 (key[1], NUM_CLASSES))
        check(shape_ok and bool(np.isfinite(got).all())
              and err <= 1e-5 * scale
              and bool((got.argmax(-1) == want.argmax(-1)).all()),
              f"{key}: shape {got.shape}, finite, kernel vs plain max abs "
              f"diff {err:.3e} (logit range {scale:.3f}), argmax agrees")

    # A reference off the card: the f32 plain path on the CPU, same weights,
    # 4 clouds. Geometry matches bit for bit; matmul summation order differs
    # (bound 1e-4 of the logit range, as the CPU tests hold the port to JAX).
    cpu = Predictor("pointnet2_cls_ssg", sd, dtype=torch.float32,
                    device="cpu")
    want = cpu(clouds[:4])
    got = run[("f32", 16)][:4]
    err = float(np.abs(got - want).max())
    check(err <= 1e-4 * float(np.abs(want).max()),
          f"f32 on the card vs the CPU, 4 clouds: max abs diff {err:.3e}")

    # bf16 vs f32 on the same weights: bf16 keeps 8 mantissa bits; the CPU
    # tests bound the bf16 port against JAX's bf16 at 2% of the logit range
    bf, f32 = run[("bf16", 100)], run[("f32", 100)]
    err = float(np.abs(bf - f32).max())
    agree = float((bf.argmax(-1) == f32.argmax(-1)).mean())
    check(err <= 0.05 * float(np.abs(f32).max()),
          f"bf16 vs f32, 100 clouds: max abs diff {err:.3e}, argmax "
          f"agreement {agree:.2f}")

    log("phase 4: predict_votes(num_votes=12) at B=16")
    votes = predictors["bf16"].predict_votes(clouds[:16], 12, rng=SEED)
    check(votes.shape == (16, NUM_CLASSES) and bool(np.isfinite(votes).all())
          and np.array_equal(votes, run["votes"]),
          "12-vote logits: (16, 40), finite, same for the same seed")
    # the same views rotated by numpy on the host instead of a f32 einsum on
    # the card: last-ulp coordinate differences, then bf16 activations
    host = predictors["bf16"].predict_votes(clouds[:16], 12, rng=SEED,
                                            on_device=False)
    err = float(np.abs(votes - host).max())
    check(err <= 0.05 * float(np.abs(host).max()),
          f"12 votes on the card vs views stacked on the host: max abs diff "
          f"{err:.3e}")

    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": None, "by": {"bytes": 0.0, "operations": 0.0}}
            for k in REPLACES}
    time_kernels(torch, dev, gpu, rows, blocks)
    log(f"phase 5: serving times (host clock, numpy in and out) on {gpu}")
    for name in ("bf16", "f32"):
        pred = predictors[name]
        for b in (16, 64):
            ms = host_ms(torch, lambda: pred(clouds[:b]), 20)
            log(f"  forward {name} B={b}: {ms:.3f} ms, "
                f"{b / ms * 1e3:.1f} clouds/s")
    torch.cuda.reset_peak_memory_stats()
    ms = host_ms(torch, lambda: predictors["bf16"].predict_votes(
        clouds[:16], 12, rng=SEED), 10)
    log(f"  predict_votes 12 votes bf16 B=16: {ms:.3f} ms, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    log(f"phase 5: where a forward's device time goes (torch.profiler) on "
        f"{gpu}")
    for b in (16, 64):
        profile_forward(torch, predictors["bf16"], clouds, b)

    check_scatter(torch, dev, check, errs)
    check_train_step(torch, dev, check, log_dir)
    fit = train_fit(torch, check, log_dir)
    serve_trained(torch, fit["state"], clouds, check)
    time_train(torch, dev, gpu, log_dir)
    time_scatter(torch, dev, gpu, rows)

    shapes = fp_shapes(torch, dev, blocks[:16], parts[:16])
    check_three_nn(torch, shapes, check, errs)
    log("phase 11: serve pointnet2_sem_seg (N=8192) and pointnet2_part_seg "
        "(N=2048, normals) through the kernels")
    sds = {name: random_state_dict(torch, SEED, name) for name in (SEM, PART)}
    preds = {(name, dt): Served(name, sds[name], t)
             for name in (SEM, PART)
             for dt, t in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    seg = drive_seg(torch, preds, blocks, parts, room)
    check_seg(torch, preds, seg, blocks, parts, room, sds, check)
    time_seg(torch, gpu, preds, shapes, blocks, parts, room, rows)

    labels = np.random.default_rng(SEED + 14).integers(0, 16, len(parts),
                                                       dtype=np.int32)
    levels = msg_levels(torch, dev, clouds[:16], parts[:16])
    check_msg_kernels(torch, dev, levels, check, errs)
    log("phase 14: serve pointnet2_cls_msg (N=1024), "
        "pointnet2_part_seg_msg_one_hot (N=2048, normals, labels) and "
        "pointnet_cls_basic through the kernels")
    msg_sds = {name: random_state_dict(torch, SEED, name)
               for name in MSG_PER_FWD}
    msg_preds = {(name, dt): Served(name, msg_sds[name], t)
                 for name in MSG_PER_FWD
                 for dt, t in (("bf16", torch.bfloat16),
                               ("f32", torch.float32))}
    msg = drive_msg(torch, dev, msg_preds, clouds, parts, labels)
    check_msg(torch, msg_preds, msg, clouds, parts, labels, msg_sds, check)
    time_msg(torch, dev, gpu, levels, msg_preds, clouds, parts, labels, rows)

    data = {CLS_SSG: clouds, CLS_MSG: clouds, SEM: blocks, PART: parts,
            PART_MSG: parts, "labels": labels}
    fused_sds = {CLS_SSG: sd, SEM: sds[SEM], PART: sds[PART],
                 CLS_MSG: msg_sds[CLS_MSG], PART_MSG: msg_sds[PART_MSG]}
    fused_preds = {**preds, **msg_preds}
    for dt, t in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        fused_preds[(CLS_SSG, dt)] = Served(CLS_SSG, sd, t)
    chains = fused_chains(torch, {name: fused_preds[(name, "f32")].pred.model
                                  for name in FUSED_MODELS})
    affine_launches = check_fused_kernels(torch, dev, chains, check, errs)
    log("phase 17: serve cls_ssg, cls_msg, sem_seg, part_seg and "
        "part_seg_msg with config.fused_mlp(True) through the kernels")
    fused = drive_fused(torch, fused_preds, data)
    check_fused(torch, fused_preds, fused, data, fused_sds, check)
    time_fused_kernels(torch, dev, gpu, chains, rows)
    time_fused_forwards(torch, gpu, fused_preds, data)

    check_fused_bwd_kernels(torch, dev, chains, check, errs)
    check_fused_train_step(torch, dev, check, log_dir)
    fused_fit = fused_train_fit(torch, check, log_dir)
    time_fused_bwd_kernels(torch, dev, gpu, chains, rows)
    time_fused_train(torch, dev, gpu, log_dir)

    seg_batches = check_seg_train_step(torch, dev, check, log_dir)
    seg_fit = seg_train_fit(torch, check, log_dir)
    time_seg_train(torch, dev, gpu, log_dir, seg_batches)

    resume = check_resume(torch, check, log_dir)
    protocols = check_protocols(torch, check, log_dir)
    journeys = check_cli(torch, check, log_dir)
    graphed = check_graphed_steps(torch, check, log_dir, gpu)
    graph_resume = check_graph_resume(torch, check, log_dir)
    remat = check_remat(torch, dev, check, log_dir, gpu, seg_batches)
    check_watchdog(torch, check, log_dir)
    normals = check_normal_txt(torch, check, log_dir)
    scale_out = check_scale_out(torch, check, log_dir, gpu)
    standins = check_standins(torch, check, log_dir)
    surface = check_surface(torch, dev, gpu, check, log_dir)
    fps_any = check_fps_any_size(torch, dev, gpu, check, errs)
    # launches of each kernel over every main-path run (classifier serving,
    # training, sem_seg and part_seg serving, the MSG models' serving and
    # the MSG layers' other routes, the fused route's serving and
    # training, segmentation training, the resumed runs, the protocols,
    # the CLI journeys, the graphed epochs (a replay counts the launches
    # recorded at its capture), the remat steps, the txt data's runs, the
    # ranks' steps and epochs of phase 31, the virtual-scan journey of
    # phase 32, phase 33's mesh sampling, dress rehearsal, visualize runs
    # and demos, phase 34's FPS calls at any size, its mesh sampling and
    # its three_nn and scatter over 65537 clouds); the affine tail runs on
    # no model path, so its phase-16 launches count
    runs = [fit["counts"], seg["launches"][SEM], seg["launches"][PART],
            *msg["launches"].values(), *fused["launches"].values(),
            fused_fit, seg_fit, resume, protocols, journeys, graphed,
            graph_resume, remat, normals, *scale_out, standins, surface,
            fps_any]
    launches = {k: launches[k] + sum(r[k] for r in runs) for k in REPLACES}
    launches["fused_affine"] += affine_launches
    check(all(launches[k] > 0 for k in REPLACES),
          "every kernel was launched in the main-path runs")
    return finish(torch, check, t_start, gpu,
                  kernel_table(rows, launches, errs))


def finish(torch, check: Checks, t_start: float, gpu: str,
           table: list | None) -> int:
    """The run's verdict: the failed checks and exit code 1, or the GPU
    line, the kernels line (a whole run's) and the last line."""
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if check.failed:
        log(f"FAILED: {len(check.failed)} check(s)")
        for what in check.failed:
            log(f"  {what}")
        return 1
    print(gpu)
    if table is not None:
        print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
