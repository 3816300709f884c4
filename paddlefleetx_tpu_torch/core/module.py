"""The module contract between the engine and a model (the port's copy
of the JAX package's ``core/module.py``).

A module builds its model (``get_model``) and computes its loss
(``loss_fn``); the engine owns the step loop and calls the host-side
hooks (``training_step_end``, ``validation_step_end``), which print the
pinned ``[train]`` / ``[eval]`` lines (``utils/log.py``).
"""

from __future__ import annotations

from typing import Any, Dict

from ..utils.log import logger


class BasicModule:
    """Subclasses implement ``get_model`` and ``loss_fn``."""

    def __init__(self, configs):
        self.configs = configs
        #: the data-parallel world size, set by the engine (1 here)
        self.nranks = 1
        self.model = self.get_model()

    def get_model(self):
        """The ``nn.Module`` this module trains."""
        raise NotImplementedError

    def loss_fn(self, model, batch, seed, train: bool = True):
        """The scalar loss of the collated ``batch`` (``seed`` draws the
        dropout masks when ``train``)."""
        raise NotImplementedError

    def validation_epoch_end(self, log_dict: Dict[str, Any]) -> None:
        """Hook after an evaluation pass."""

    def training_epoch_end(self, log_dict: Dict[str, Any]) -> None:
        """Hook after a training epoch."""
        logger.info("[Training] epoch: %d, total time: %.5f sec",
                    log_dict["epoch"], log_dict["train_cost"])


class LanguageModule(BasicModule):
    """A module whose step lines carry the language-model throughput."""

    def training_step_end(self, log_dict: Dict[str, Any]) -> None:
        """Print the ``[train]`` line in the grammar of
        ``utils/log.py:TRAIN_LINE_RE``."""
        speed = 1.0 / log_dict["train_cost"]
        tokens = self.configs.Global.global_batch_size * \
            log_dict["max_seq_len"]
        logger.train(
            "[train] epoch: %d, batch: %d, loss: %.9f, "
            "avg_batch_cost: %.5f sec, speed: %.2f step/s, "
            "ips_total: %.0f tokens/s, ips: %.0f tokens/s, "
            "learning rate: %.5e",
            log_dict["epoch"], log_dict["batch"], log_dict["loss"],
            log_dict["train_cost"], speed, speed * tokens,
            speed * tokens / max(self.nranks, 1), log_dict["lr"])

    def validation_step_end(self, log_dict: Dict[str, Any]) -> None:
        """Print the ``[eval]`` line in the grammar of
        ``utils/log.py:EVAL_LINE_RE``."""
        speed = 1.0 / log_dict["eval_cost"]
        logger.eval(
            "[eval] epoch: %d, batch: %d, loss: %.9f, avg_eval_cost: "
            "%.5f sec, speed: %.2f step/s", log_dict["epoch"],
            log_dict["batch"], log_dict["loss"], log_dict["eval_cost"],
            speed)
