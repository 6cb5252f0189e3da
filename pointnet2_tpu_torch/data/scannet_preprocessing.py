"""ScanNet raw-export preprocessing: raw scans -> per-scene npy files.

The port's copy of pointnet2_tpu/data/scannet_preprocessing.py, numpy and
the standard library alone; the cleaned PLY is read by the port's own
reader (utils/pc_util.py), not by ``plyfile``. A re-implementation of the
reference preprocessing
(scannet/preprocessing/collect_scannet_scenes.py:19-102 and
scannet_util.py): reads each scene's over-segmentation json, aggregation
json, and cleaned ply, maps raw instance labels to the 20-class NYU40
subset (+ 'unannotated'), and writes (N, 8) npy arrays
[x y z r g b instance_id semantic_label].

Requires the raw ScanNet export (scannet_clean_2 layout) and the
`scannet-labels.combined.tsv` label-mapping table shipped with ScanNet —
neither is redistributable, so paths are explicit arguments.
"""

from __future__ import annotations

import json
import os

import numpy as np

from pointnet2_tpu_torch.utils import pc_util

# the 21 training classes (20 NYU40 categories + unannotated), in the
# reference's label order (scannet_util.py:3)
CLASS_NAMES = [
    "unannotated", "wall", "floor", "chair", "table", "desk", "bed",
    "bookshelf", "sofa", "sink", "bathtub", "toilet", "curtain", "counter",
    "door", "window", "shower curtain", "refridgerator", "picture",
    "cabinet", "otherfurniture",
]


def load_raw2scannet_label_map(tsv_path: str) -> dict[str, str]:
    """Parse scannet-labels.combined.tsv: raw label -> one of CLASS_NAMES
    (column 6 holds the nyu40 class name; unknown -> 'unannotated')."""
    valid = set(CLASS_NAMES)
    raw2scannet = {}
    with open(tsv_path) as f:
        lines = [line.rstrip("\n") for line in f][1:]
    for line in lines:
        elements = line.split("\t")
        raw_name = elements[0]
        nyu40_name = elements[6] if len(elements) > 6 else ""
        raw2scannet[raw_name] = nyu40_name if nyu40_name in valid \
            else "unannotated"
    return raw2scannet


def read_ply_xyzrgb(filename: str) -> np.ndarray:
    """Read (N, 6) xyzrgb from a (binary or ascii) PLY file."""
    return pc_util.read_ply_xyzrgb(filename)


def collect_one_scene(scannet_dir: str, scene_name: str,
                      raw2scannet: dict[str, str]) -> np.ndarray:
    """Assemble one scene's (N, 8) array [xyz rgb instance semantic]."""
    folder = os.path.join(scannet_dir, scene_name)
    with open(os.path.join(
            folder, f"{scene_name}_vh_clean_2.0.010000.segs.json")) as f:
        seg = json.load(f)["segIndices"]
    segid_to_pointid: dict[int, list[int]] = {}
    for i, s in enumerate(seg):
        segid_to_pointid.setdefault(s, []).append(i)

    points = read_ply_xyzrgb(
        os.path.join(folder, f"{scene_name}_vh_clean_2.ply"))

    with open(os.path.join(folder, f"{scene_name}.aggregation.json")) as f:
        agg = json.load(f)["segGroups"]

    chunks = []
    for inst_id, group in enumerate(agg):
        pointids = []
        for segid in group["segments"]:
            pointids += segid_to_pointid[segid]
        inst_pts = points[np.asarray(pointids)][:, 0:6]
        label_name = raw2scannet.get(group["label"], "unannotated")
        label = CLASS_NAMES.index(label_name)
        n = inst_pts.shape[0]
        chunks.append(np.concatenate(
            [inst_pts, np.full((n, 1), inst_id, np.float64),
             np.full((n, 1), label, np.float64)], axis=1))
    return np.concatenate(chunks, axis=0)


def collect_scenes(scannet_dir: str, scene_names: list[str],
                   label_tsv: str, output_folder: str,
                   log_fn=print) -> None:
    """Batch-convert scenes to <output_folder>/<scene>.npy."""
    os.makedirs(output_folder, exist_ok=True)
    raw2scannet = load_raw2scannet_label_map(label_tsv)
    for scene_name in scene_names:
        log_fn(scene_name)
        try:
            data = collect_one_scene(scannet_dir, scene_name, raw2scannet)
            np.save(os.path.join(output_folder, scene_name + ".npy"), data)
        except Exception as e:  # mirror reference: log and continue
            log_fn(f"{scene_name} ERROR!! {e}")


def scenes_to_pickle_lists(npy_folder: str, scene_names: list[str]):
    """Convert per-scene npy files into the (points_list, labels_list)
    pair the training pipelines consume (xyz only + semantic label)."""
    pts_list, lbl_list = [], []
    for name in scene_names:
        data = np.load(os.path.join(npy_folder, name + ".npy"))
        pts_list.append(data[:, 0:3].astype(np.float32))
        lbl_list.append(data[:, 7].astype(np.int32))
    return pts_list, lbl_list


def collect_label_names(scannet_dir: str, scene_names: list[str]) -> list[str]:
    """Scan every scene's aggregation json for the complete set of raw
    category labels (scannet/preprocessing/fetch_label_names.py)."""
    labels = set()
    for scene_name in scene_names:
        path = os.path.join(scannet_dir, scene_name,
                            scene_name + ".aggregation.json")
        with open(path) as f:
            for group in json.load(f)["segGroups"]:
                labels.add(group["label"])
    return sorted(labels)


def export_demo_scene(scene_npy: str, output_folder: str) -> None:
    """Dump a preprocessed scene as colored PLY point files for inspection:
    raw RGB + instance-colored + semantic-colored. Mirrors
    scannet/preprocessing/demo.py (which writes PLY-format content into
    .obj-named files; here the files are honest .ply)."""
    data = np.load(scene_npy)
    os.makedirs(output_folder, exist_ok=True)
    pts = data[:, 0:3]
    pc_util.write_ply_rgb(pts, data[:, 3:6],
                  os.path.join(output_folder, "scene.ply"))
    pc_util.write_ply_color(pts, data[:, 6].astype(int),
                    os.path.join(output_folder, "scene_instance.ply"))
    pc_util.write_ply_color(pts, data[:, 7].astype(int),
                    os.path.join(output_folder, "scene_semantic.ply"))
