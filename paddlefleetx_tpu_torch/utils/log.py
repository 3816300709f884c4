"""Logging for the port (a copy of the JAX package's logger setup).

Same line format as ``paddlefleetx_tpu/utils/log.py``; the TRAIN/EVAL
levels and their grammar arrive with the training slice.
"""

from __future__ import annotations

import logging
import sys


class _Formatter(logging.Formatter):
    def __init__(self):
        super().__init__("[%(asctime)s] [%(levelname)8s] - %(message)s",
                         "%Y-%m-%d %H:%M:%S")


def _build_logger() -> logging.Logger:
    lg = logging.getLogger("paddlefleetx_tpu_torch")
    if not lg.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(_Formatter())
        lg.addHandler(handler)
        lg.setLevel(logging.INFO)
        lg.propagate = False
    return lg


logger: logging.Logger = _build_logger()
