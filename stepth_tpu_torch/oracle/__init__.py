"""Exact NumPy oracle of the reference semantics (twin of
``stepth_tpu/oracle``): the parity anchor that ``match.parity`` and the
native host engine are held to, with no JAX and nothing of the JAX
package (docs/SEMANTICS.md)."""

from stepth_tpu_torch.oracle import kmeans, pipeline, resize, ring, subdivision

__all__ = ["kmeans", "pipeline", "resize", "ring", "subdivision"]
