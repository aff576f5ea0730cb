"""Host-side utilities: checkpoints, numerical checks, metrics, the process
supervisor, tracing, scenes and the synthetic rig."""

from stepth_tpu_torch.utils import (checkpoint, debug, metrics, supervisor,  # noqa: F401
                                    tracing)
