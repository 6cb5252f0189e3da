"""Every cell's inputs have the same shapes whatever the seed; the seed
changes only their content."""

import numpy as np

from portbench.harness import serve_blocks, spec, train_epochs


def test_block_requests_have_fixed_shapes():
    bench = spec.load_benchmark()
    cell = spec.workload(bench, "sem_seg.serve_blocks")
    cfg = spec.config(bench, cell["config"])
    mix = dict(spec.traffic(cell["traffic"]), pool_requests=1)
    pools = [serve_blocks.make_pool(cfg, mix, s) for s in (0, 2 ** 31 + 9)]
    shape = (mix["blocks_per_request"], mix["points_per_block"], 3)
    for pool in pools:
        assert [r.shape for r in pool] == [shape]
        assert all(r.dtype == np.float32 for r in pool)
    assert not np.array_equal(pools[0][0], pools[1][0])


def test_train_batches_have_fixed_shapes():
    bench = spec.load_benchmark()
    cell = spec.workload(bench, "cls_ssg.train")
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    B = mix["batch_per_chip"] * cell["chips"]
    sets = [train_epochs.make_data(cfg, B, s) for s in (1, 2 ** 31 + 9)]
    assert len(sets[0]) == len(sets[1]) == cfg["train_clouds"]
    assert sets[0].num_batches() == sets[1].num_batches()
    for ds in sets:
        shapes = {tuple(b["points"].shape) for b in ds.epoch()}
        assert shapes == {(B, cfg["num_point"], cfg["in_channels"])}
    assert not np.array_equal(sets[0].data, sets[1].data)
