"""treee-tpu on PyTorch and CUDA: the port of ``treee_tpu`` to one NVIDIA H100.

Imports torch and numpy only, never JAX.  ``pipeline.Session`` holds a
cloud on one device and drives everything on it; the front ends run it:
``python -m treee_tpu_torch`` (``app.py``, the CLI), ``--repl``
(``repl.py``) and ``--serve PORT`` (``serve.py``, the browser viewer).  On a
CUDA device the hand-written kernels (``ops/kernels``) run; on the CPU,
asked for with ``device="cpu"`` or ``--cpu``, their plain PyTorch versions
do.
"""

from .cloud import PointCloud
from .config import (CharacteristicsConfig, Config, DEFAULT_CONFIG,
                     SegmentationConfig)

__all__ = ["CharacteristicsConfig", "Config", "DEFAULT_CONFIG", "PointCloud",
           "SegmentationConfig"]
