"""Inputs of the data kind ``synthetic_classification``: ModelNet40-sized
classification clouds made in memory from the seed by the port's
``data/synthetic.py`` ``SyntheticClassification`` (one fixed blob
arrangement a class; ``portbench/tests/test_portbench_inputs.py`` holds it
to a frozen copy of its generator).

``train_set(cfg, batch, seed)``: the data set a training cell hands to
``Trainer``, ``cfg["data"]["samples_per_class"]`` clouds of each of its
``num_classes`` classes, ``cfg["num_point"]`` points of
``cfg["in_channels"]`` channels, ``batch`` clouds a batch.
"""

from __future__ import annotations


def train_set(cfg: dict, batch: int, seed: int):
    from pointnet2_tpu_torch.data import SyntheticClassification

    d = cfg["data"]
    return SyntheticClassification(
        num_classes=d["num_classes"], samples_per_class=d["samples_per_class"],
        npoints=cfg["num_point"], channels=cfg["in_channels"],
        batch_size=batch, seed=seed)
