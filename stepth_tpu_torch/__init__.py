"""stepth_tpu_torch — the PyTorch/CUDA port of stepth_tpu.

The JAX package ``stepth_tpu`` is the reference; every module here keeps the
name of its counterpart there so a reader can find one from the other. The
port imports ``torch`` and never ``jax``: plain tensor code is PyTorch, and
each Pallas kernel of the reference becomes a CUDA C++ kernel for Hopper
(``sm_90a``) under ``csrc/``, built at its first launch (``kernels/``).

What runs today: the reference's own flows, ``core.frame.DepthFrame`` →
``load_depth_from_additional`` (the parity pipeline of ``match.parity``:
subdivision, ring search, normalise) → ``invert_depth`` →
``select_foreground`` → ``apply_mask`` with ``MaskFrame``'s mask algebra and
masked adjustments, the prefetching ``core.loader`` and the command line
(``python -m stepth_tpu_torch depth|stereo|video|foreground``);
``models.stereo.StereoModel`` with all eight backends of the reference:
``"hierarchical-pallas"`` (SAD, SSD or census cost, with or without
``lr_check``: grayscale, the image pyramid, the fused exhaustive matcher at
the coarsest level in ``match.fused_dense``, the tile-base refine kernel at
every finer level in ``match.fused_refine``, then the LR check, the
occlusion fill and the 3×3 median in ``match.fused_post``), ``"pallas"``
(the exhaustive matcher at full resolution, ``flagship()``), ``"dense"``
and ``"hierarchical"`` (plain torch), the SGM backends
``"hierarchical-sgm"``, ``"sgm-pallas"`` and ``"sgm"``, and ``"parity"``,
plus ``batched()``, the temporally seeded ``video()`` and ``sharded()``;
and the calibrated-rig path around them: ``ops.photometric`` (gain match),
``ops.rectify`` (maps once per rig, then one bilinear remap per view, kernel
K11 in ``ops.fused_remap``), ``fusion.geometry`` (metric depth, points) and
``core.io.save_ply``, with the depth utilities of ``ops`` (``kmeans``,
``depth``, ``mask``, ``resize``, ``adjust``, ``temporal``).

Every function takes its device from its input tensors. A tensor on the CPU
runs each kernel's plain PyTorch version; a CUDA tensor launches the kernel
or raises.
"""

from stepth_tpu_torch import config
from stepth_tpu_torch.config import MatchConfig, PyramidConfig, SGMConfig
from stepth_tpu_torch.core.frame import MASK_FALSE, MASK_TRUE, DepthFrame, MaskFrame

__version__ = "0.1.0"

__all__ = [
    "DepthFrame",
    "MaskFrame",
    "MASK_TRUE",
    "MASK_FALSE",
    "config",
    "MatchConfig",
    "PyramidConfig",
    "SGMConfig",
    "__version__",
]
