"""stepth_tpu_torch — the PyTorch/CUDA port of stepth_tpu.

The JAX package ``stepth_tpu`` is the reference; every module here keeps the
name of its counterpart there so a reader can find one from the other. The
port imports ``torch`` and never ``jax``: plain tensor code is PyTorch, and
each Pallas kernel of the reference becomes a CUDA C++ kernel for Hopper
(``sm_90a``) under ``csrc/``, built at its first launch (``kernels/``).

What runs today: ``models.stereo.StereoModel(backend="hierarchical-pallas")``
with SAD/SSD costs and no LR check — grayscale, the image pyramid, the fused
exhaustive matcher at the coarsest level (``match.fused_dense``), the
tile-base refine kernel at every finer level (``match.fused_refine``) and the
3×3 median (``match.fused_post``).

Every function takes its device from its input tensors. A tensor on the CPU
runs each kernel's plain PyTorch version; a CUDA tensor launches the kernel
or raises.
"""

from stepth_tpu_torch.config import MatchConfig, PyramidConfig, SGMConfig

__version__ = "0.1.0"

__all__ = ["MatchConfig", "PyramidConfig", "SGMConfig"]
