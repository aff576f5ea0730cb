"""Multi-device parallelism: device meshes and row-tile-sharded matching
with halo exchange and carry relays (twin of ``stepth_tpu/parallel``)."""

from stepth_tpu_torch.parallel import mesh, sharded  # noqa: F401
