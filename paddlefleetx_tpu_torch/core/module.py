"""The module contract between the engine and a model (the port's copy
of the JAX package's ``core/module.py``).

A module builds its model (``get_model``) and computes its loss
(``loss_fn``) and its test output (``predict_step``, by default the
eval-mode loss); the engine owns the step loop and calls the host-side
hooks: ``pretreating_batch`` on each host batch before it moves to the
device, and ``training_step_end``, ``validation_step_end`` and
``test_step_end``, which print the pinned ``[train]`` / ``[eval]`` lines
(``utils/log.py``) and the ``[test]`` line.
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

    def predict_step(self, model, batch, seed):
        """The test output of the collated ``batch`` for
        ``Engine.predict``: the eval-mode loss by default (the JAX
        ``predict_step``); override to return other predictions (a
        tensor, or a dict with a ``loss`` entry for the log line)."""
        return self.loss_fn(model, batch, seed, train=False)

    def pretreating_batch(self, batch):
        """Hook on each host batch before the engine moves it to the
        device; returns the batch to use."""
        return batch

    def validation_step_end(self, log_dict: Dict[str, Any]) -> None:
        """Hook after each evaluation batch."""

    def validation_epoch_end(self, log_dict: Dict[str, Any]) -> None:
        """Hook after an evaluation pass."""

    def test_step_end(self, log_dict: Dict[str, Any]) -> None:
        """Hook after each ``Engine.predict`` batch."""

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

    def test_step_end(self, log_dict: Dict[str, Any]) -> None:
        """Print the ``[test]`` line of one ``Engine.predict`` batch."""
        speed = 1.0 / log_dict["test_cost"]
        logger.info(
            "[test] epoch: %d, batch: %d, loss: %.9f, avg_test_cost: "
            "%.5f sec, speed: %.2f step/s", log_dict["epoch"],
            log_dict["batch"], log_dict["loss"], log_dict["test_cost"],
            speed)
