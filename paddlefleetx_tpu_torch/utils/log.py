"""Logging for the port (a copy of the JAX package's logger setup).

Same line format and the same extra TRAIN / EVAL levels as
``paddlefleetx_tpu/utils/log.py``, so the ``[train]`` / ``[eval]`` lines
a benchmark harness greps read the same from either package;
``TRAIN_LINE_RE`` / ``EVAL_LINE_RE`` pin that grammar.
"""

from __future__ import annotations

import logging
import sys

TRAIN = 21
EVAL = 22

logging.addLevelName(TRAIN, "TRAIN")
logging.addLevelName(EVAL, "EVAL")


class _Formatter(logging.Formatter):
    def __init__(self):
        super().__init__("[%(asctime)s] [%(levelname)8s] - %(message)s",
                         "%Y-%m-%d %H:%M:%S")


class Logger(logging.Logger):
    """``logging.Logger`` with ``.train()`` / ``.eval()`` levels."""

    def train(self, msg, *args, **kwargs):
        """Log at the TRAIN level (the per-step ``[train]`` line)."""
        if self.isEnabledFor(TRAIN):
            self._log(TRAIN, msg, args, **kwargs)

    def eval(self, msg, *args, **kwargs):
        """Log at the EVAL level (the ``[eval]`` line)."""
        if self.isEnabledFor(EVAL):
            self._log(EVAL, msg, args, **kwargs)


def _build_logger() -> Logger:
    logging.setLoggerClass(Logger)
    lg = logging.getLogger("paddlefleetx_tpu_torch")
    logging.setLoggerClass(logging.Logger)
    if not lg.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(_Formatter())
        lg.addHandler(handler)
        lg.setLevel(logging.INFO)
        lg.propagate = False
    return lg  # type: ignore[return-value]


logger: Logger = _build_logger()

#: the pinned grammar of the ``[train]`` and ``[eval]`` lines (the JAX
#: package's ``TRAIN_LINE_RE`` / ``EVAL_LINE_RE``)
TRAIN_LINE_RE = (
    r"\[train\] epoch: \d+, batch: \d+, loss: \d+\.\d{9}, "
    r"avg_batch_cost: \d+\.\d{5} sec, speed: \d+\.\d{2} step/s, "
    r"ips_total: \d+ tokens/s, ips: \d+ tokens/s, "
    r"learning rate: \d\.\d{5}e[+-]\d+")
EVAL_LINE_RE = (
    r"\[eval\] epoch: \d+, batch: \d+, loss: \d+\.\d{9}, "
    r"avg_eval_cost: \d+\.\d{5} sec, speed: \d+\.\d{2} step/s")
