"""The port's demos, run as ``python -m pointnet2_tpu_torch.examples.<name>``:
``mesh_sampling_demo``, ``interpolation_demo`` and
``scene_inference_demo`` (ports of the JAX package's ``examples/``)."""
