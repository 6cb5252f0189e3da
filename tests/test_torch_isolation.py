"""The port stands alone: importing all of it, and chip_smoke.py, loads
nothing of JAX, Flax or the JAX package, nor any of the optional packages
the card's machine lacks (h5py, matplotlib, PIL, OpenCV, plyfile: the
modules that use them import them at the call), and its entry points refuse to run
on the CPU unless asked to: the single-device ones, and the scale-out ones
(``Predictor(num_devices=2)``, ``Trainer`` with ``num_devices``, the
mesh, the launcher of CUDA ranks). Run in a fresh interpreter, so the test
process's own imports do not count."""

import os
import subprocess
import sys
import textwrap

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    import pointnet2_tpu_torch as pkg
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(info.name)
    import chip_smoke  # noqa: F401  (runs nothing at import)
    from pointnet2_tpu_torch.ops import fused_mlp  # noqa: F401
    from pointnet2_tpu_torch.parallel import launch, mesh, multihost
    # the generators, the virtual scan and its sampler, the older reader
    from pointnet2_tpu_torch.data import (PartDataset,  # noqa: F401
                                          ScannetDatasetVirtualScan,
                                          procedural_modelnet,
                                          procedural_scannet,
                                          procedural_shapenet_part)
    from pointnet2_tpu_torch.utils import scene_util  # noqa: F401
    # the rest of the surface: parity-day tools, viewers and plots, the
    # layer zoo, mesh sampling, profiling and the demos
    from pointnet2_tpu_torch.cli import plot_metrics, visualize  # noqa: F401
    from pointnet2_tpu_torch.data import (ingest,  # noqa: F401
                                          scannet_preprocessing)
    from pointnet2_tpu_torch.examples import (  # noqa: F401
        interpolation_demo, mesh_sampling_demo, scene_inference_demo)
    from pointnet2_tpu_torch.nn import extras  # noqa: F401
    from pointnet2_tpu_torch.ops import mesh as ops_mesh  # noqa: F401
    from pointnet2_tpu_torch.ops import prob_sample  # noqa: F401
    from pointnet2_tpu_torch.utils import pc_util, png, profiling  # noqa
    from pointnet2_tpu_torch.viz import viewer  # noqa: F401
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                        "h5py", "matplotlib", "PIL", "cv2",
                                        "plyfile")
                 or m == "pointnet2_tpu" or m.startswith("pointnet2_tpu."))
    assert not bad, bad
    import tempfile
    import torch
    assert not torch.cuda.is_available()
    tmp = tempfile.mkdtemp()
    from pointnet2_tpu_torch import (Predictor, PointNet2ClsMSG,
                                     PointNet2ClsSSG, PointNet2PartSeg,
                                     PointNet2PartSegMSGOneHot,
                                     PointNet2SemSeg, PointNetClsBasic,
                                     TrainConfig, Trainer)
    for make in (lambda: Predictor("pointnet2_cls_ssg"),
                 lambda: Predictor("pointnet2_sem_seg"),
                 lambda: Predictor("pointnet2_part_seg"),
                 lambda: Predictor("pointnet2_cls_msg"),
                 lambda: Predictor("pointnet2_part_seg_msg_one_hot"),
                 lambda: Predictor("pointnet_cls_basic"),
                 lambda: PointNet2ClsSSG(),
                 lambda: PointNet2SemSeg(),
                 lambda: PointNet2PartSeg(),
                 lambda: PointNet2ClsMSG(),
                 lambda: PointNet2PartSegMSGOneHot(),
                 lambda: PointNetClsBasic(),
                 lambda: Trainer(TrainConfig(model="pointnet2_cls_msg")),
                 lambda: Trainer(TrainConfig()),
                 lambda: Trainer(TrainConfig(num_devices=1)),
                 lambda: Predictor("pointnet2_cls_ssg", num_devices=2),
                 lambda: mesh.make_mesh(1),
                 lambda: mesh_sampling_demo.main(["--out", tmp]),
                 lambda: interpolation_demo.main(["--out", tmp]),
                 lambda: scene_inference_demo.main(["--min_points", "10",
                                                    "--max_points", "20"]),
                 lambda: visualize.main(["--model", "pointnet_cls_basic",
                                         "--synthetic", "--out", tmp,
                                         "--log_dir", tmp])):
        try:
            make()
        except RuntimeError as e:
            assert "CUDA is not available" in str(e), e
        else:
            raise AssertionError("an entry point ran without a card")
    try:
        launch.spawn(print, 2)  # CUDA ranks on a host with no card
    except ValueError as e:
        assert "0 card(s)" in str(e), e
    else:
        raise AssertionError("CUDA ranks started without a card")
    assert multihost.process_count() == 1 and multihost.is_primary()
    print("isolated", len([m for m in sys.modules
                           if m.startswith("pointnet2_tpu_torch")]))
""")


def test_port_imports_nothing_of_jax_and_needs_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("isolated")
