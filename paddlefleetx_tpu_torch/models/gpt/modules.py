"""GPT task modules (the port's counterparts of the JAX package's
``models/gpt/modules.py``): ``GPTModule`` (the training module: model,
loss, step lines), ``GPTEvalModule`` (offline WikiText perplexity and
LAMBADA cloze accuracy) and ``GPTGenerationModule`` (config -> model ->
tokenizer -> generation).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Union

import torch

from ...core.module import LanguageModule
from ...data.tokenizers.gpt_tokenizer import GPTTokenizer
from ...utils.device import resolve_device
from ...utils.log import logger
from ..language_utils import process_configs, process_model_configs
from .config import GPTConfig
from .generation import GenerationConfig, generate, left_pad_batch
from .model import (
    build_model, chunked_lm_loss, chunked_nll_sums, compute_context,
    cross_entropy_loss, tied_logits,
)


class GPTModule(LanguageModule):
    """The GPT causal-LM training module.

    Args:
        configs: the parsed config tree (``utils.config.get_config``).
        state_dict (dict): initial weights (for example from
            ``convert.torch_state_dict_from_flax``); None draws them
            from ``Global.seed``.
        device: ``None`` (the card; raises without one), ``"cuda"`` or
            ``"cpu"``.
    """

    def __init__(self, configs, state_dict=None,
                 device: Optional[Union[str, torch.device]] = None):
        process_configs(configs)
        self.device = resolve_device(device)
        self._state_dict = state_dict
        super().__init__(configs)

    def get_model(self):
        """``GPTForPretraining`` with fp32 master weights on the
        module's device (an MoE model when ``moe_num_experts > 0``);
        pipeline parallelism and QAT raise."""
        dist = self.configs.get("Distributed") or {}
        if (dist.get("pp_degree") or 1) > 1:
            raise NotImplementedError(
                "pipeline parallelism is not ported (pp_degree > 1)")
        if (self.configs.get("Quantization") or {}).get("enable"):
            raise NotImplementedError("QAT is not ported")
        self.model_config = GPTConfig.from_config(self.configs)
        seed = int(self.configs.Global.get("seed", 1024))
        model = build_model(self.model_config, self.device,
                            state_dict=self._state_dict, seed=seed,
                            train=True)
        self._state_dict = None
        return model

    def loss_fn(self, model, batch, seed: int, train: bool = True
                ) -> torch.Tensor:
        """The masked-mean LM loss of ``batch`` = ``(tokens,
        position_ids, labels, loss_mask)`` on the model's device. With
        ``train`` and a dropout probability above 0, ``seed`` draws the
        dropout masks; otherwise the forward is deterministic. With
        ``loss_chunks > 1`` the loss is chunked (``chunked_lm_loss``).
        An MoE model's router loss is added for ``train`` only: the eval
        loss is the pure cross-entropy, as in the JAX package."""
        tokens, position_ids, labels, loss_mask = batch
        cfg = self.model_config
        drop = train and (cfg.hidden_dropout_prob > 0.0 or
                          cfg.attention_probs_dropout_prob > 0.0)
        dropout_seed = int(seed) if drop else None
        with compute_context(cfg, tokens.device):
            if cfg.loss_chunks > 1:
                return chunked_lm_loss(model, tokens, labels, loss_mask,
                                       cfg.loss_chunks, position_ids,
                                       dropout_seed, return_aux=train)
            logits, aux = model(tokens, position_ids,
                                dropout_seed=dropout_seed, return_aux=True)
            return cross_entropy_loss(logits, labels, loss_mask,
                                      aux if train else None)

    def input_spec(self):
        """``[((micro_batch, seq), "int64")] * 2``: tokens and
        positions."""
        data = self.configs.get("Data") or {}
        section = data.get("Train") or data.get("Eval")
        seq = section["dataset"]["max_seq_len"] if section else \
            self.model_config.max_position_embeddings
        micro = self.configs.Global.micro_batch_size
        return [((micro, seq), "int64"), ((micro, seq), "int64")]

    def training_step_end(self, log_dict: Dict[str, Any]) -> None:
        """The ``[train]`` line, with the train sequence length."""
        log_dict.setdefault(
            "max_seq_len", self.configs.Data.Train.dataset.max_seq_len)
        super().training_step_end(log_dict)


class GPTModuleAuto(GPTModule):
    """The module the auto-parallel recipes (``configs/nlp/gpt/auto/``)
    name: a :class:`GPTModule` and nothing more, as in the JAX package,
    where the auto engine is the same trainer."""


class GPTEvalModule(GPTModule):
    """Offline evaluation: WikiText perplexity (``LM_Eval_Dataset``) or
    LAMBADA cloze accuracy (``Lambada_Eval_Dataset``), as set by the
    ``Offline_Eval`` section (the JAX ``GPTEvalModule``).

    The ``Data.Eval`` section is rewritten to the evaluation dataset
    over ``Offline_Eval.eval_path``, the ``gpt_eval_collate_fn`` and a
    ``GPTBatchSampler`` of ``Offline_Eval.batch_size`` that neither
    shuffles nor drops the short last batch. ``loss_fn`` scores one
    batch: the summed NLL of its masked targets (LM) or the number of
    rows whose every masked target is the argmax (cloze); the host hooks
    accumulate the scores and ``validation_epoch_end`` sets ``metrics``
    to ``{loss, ppl, adjusted_ppl}`` or ``{acc, correct}``.

    The forward is deterministic, and an MoE model computes no router
    loss; each batch row is one routing group of ``max_seq_len`` tokens.
    The LM head and its softmax run over ``Model.loss_chunks`` sequence
    chunks, so the ``[b, s, vocab]`` logits are never held whole.

    Args: as :class:`GPTModule`.
    """

    def __init__(self, configs, state_dict=None,
                 device: Optional[Union[str, torch.device]] = None):
        self.eval_cfgs = configs.Offline_Eval
        self.cloze_eval = bool(self.eval_cfgs.get("cloze_eval", False))
        self._post_process_configs(configs)
        super().__init__(configs, state_dict=state_dict, device=device)
        self.total_score = 0.0
        self.first_step = True
        self.num_original_tokens = None
        self.num_tokenized_tokens = None
        self.num_examples = None
        self.metrics: Dict[str, float] = {}

    def _post_process_configs(self, configs) -> None:
        data_eval = configs.Data.Eval
        data_eval.dataset["input_dir"] = self.eval_cfgs.eval_path
        data_eval.dataset["max_seq_len"] = self.eval_cfgs.get(
            "max_seq_len", data_eval.dataset.get("max_seq_len", 1024))
        if self.cloze_eval:
            data_eval.dataset["name"] = "Lambada_Eval_Dataset"
        else:
            data_eval.dataset["name"] = "LM_Eval_Dataset"
            data_eval.dataset["overlapping_eval"] = self.eval_cfgs.get(
                "overlapping_eval", 32)
        data_eval["loader"] = data_eval.get("loader") or {}
        data_eval.loader["collate_fn"] = "gpt_eval_collate_fn"
        data_eval["sampler"] = {
            "name": "GPTBatchSampler",
            "batch_size": self.eval_cfgs.get("batch_size", 8),
            "shuffle": False, "drop_last": False}

    def loss_fn(self, model, batch, seed: int, train: bool = False
                ) -> torch.Tensor:
        """The score of one collated evaluation batch (``(tokens,
        loss_mask, attention_mask, position_ids, labels, info)`` on the
        model's device), an fp32 scalar: the summed NLL over the masked
        targets, or in cloze mode the number of rows whose every masked
        target is the argmax of its fp32 logits."""
        tokens, loss_mask, _attn, position_ids, labels, _info = batch
        cfg = self.model_config
        emb = model.word_embeddings
        with compute_context(cfg, tokens.device):
            h = model.gpt(tokens, position_ids)
            if not self.cloze_eval:
                return chunked_nll_sums(h, emb, labels, loss_mask,
                                        cfg.loss_chunks)[0]
            step = -(-tokens.shape[1] // max(cfg.loss_chunks, 1))
            rows = torch.ones(tokens.shape[0], dtype=torch.bool,
                              device=tokens.device)
            for sl in range(0, tokens.shape[1], step):
                part = slice(sl, sl + step)
                pred = tied_logits(h[:, part], emb).float().argmax(dim=-1)
                hit = torch.where(loss_mask[:, part] > 0,
                                  pred == labels[:, part], True)
                rows = rows & hit.all(dim=-1)
            return rows.float().sum()

    def pretreating_batch(self, batch):
        """Read the dataset's ``info`` (token or example counts) from
        the first host batch."""
        if self.first_step:
            info = batch[-1]
            if self.cloze_eval:
                self.num_examples = int(info[0][0])
            else:
                self.num_original_tokens = int(info[0][0])
                self.num_tokenized_tokens = int(info[0][1])
            self.first_step = False
        return batch

    def validation_step_end(self, log_dict: Dict[str, Any]) -> None:
        """Accumulate the batch's score: its NLL over the tokenized
        length less one, or its number of correct rows."""
        if not self.cloze_eval:
            self.total_score += log_dict["loss"] / (
                self.num_tokenized_tokens - 1)
            name = "loss"
        else:
            self.total_score += log_dict["loss"]
            name = "number correct"
        logger.eval("[eval] epoch: %d, batch: %d, %s: %.9f",
                    log_dict["epoch"], log_dict["batch"], name,
                    self.total_score)

    def validation_epoch_end(self, log_dict: Dict[str, Any]) -> None:
        """Set ``metrics``: the mean NLL, the perplexity and the
        perplexity adjusted to the original token count (each exponent
        clipped at 20), or the cloze accuracy and count."""
        if not self.cloze_eval:
            total_loss = float(self.total_score)
            ppl = math.exp(min(20, total_loss))
            token_ratio = (self.num_tokenized_tokens - 1) / (
                self.num_original_tokens - 1)
            adjusted_ppl = math.exp(min(20, total_loss * token_ratio))
            logger.info(
                "validation results | avg loss: %.4E | ppl: %.4E | "
                "adjusted ppl: %.4E | token ratio: %s", total_loss, ppl,
                adjusted_ppl, token_ratio)
            self.metrics = {"loss": total_loss, "ppl": ppl,
                            "adjusted_ppl": adjusted_ppl}
        else:
            correct = float(self.total_score)
            acc = correct / self.num_examples
            logger.info(
                "validation results | number correct: %.4E | total "
                "examples: %.4E | avg accuracy: %.4E", correct,
                self.num_examples, acc)
            self.metrics = {"acc": acc, "correct": correct}


class GPTGenerationModule:
    """Text in, generated text out, from a parsed YAML config.

    Args:
        configs: the parsed config tree (``utils.config.get_config``).
        state_dict (dict): the model's weights (for example from
            ``convert.torch_state_dict_from_flax``); None draws them
            from ``Global.seed``.
        device: ``None`` (the card; raises without one), ``"cuda"`` or
            ``"cpu"``.
    """

    def __init__(self, configs, state_dict=None,
                 device: Optional[Union[str, torch.device]] = None):
        process_model_configs(configs)
        self.configs = configs
        self.device = resolve_device(device)
        self.seed = int(configs.get("Global", {}).get("seed", 1024))
        self.model_config = GPTConfig.from_config(configs)
        self.model = build_model(self.model_config, self.device,
                                 state_dict=state_dict, seed=self.seed)
        gen_section = dict(configs.get("Generation", {}) or {})
        self.tokenizer = GPTTokenizer.from_pretrained(
            gen_section.get("vocab_dir", "gpt2"))
        gen_section.setdefault("eos_token_id", self.tokenizer.eos_token_id)
        gen_section.setdefault("pad_token_id", self.tokenizer.pad_token_id)
        self.generation_cfg = GenerationConfig.from_config(gen_section)

    def generate(self, texts, seed: Optional[int] = None) -> List[str]:
        """Tokenize ``texts`` (a string or a list), left-pad them to a
        batch, decode with the configured strategy and return one
        string per output row (text before the first EOS)."""
        if isinstance(texts, str):
            texts = [texts]
        ids, mask = left_pad_batch([self.tokenizer.encode(t) for t in texts],
                                   self.tokenizer.pad_token_id)
        out = generate(self.model, ids, mask, self.generation_cfg,
                       self.seed if seed is None else seed)
        eos = self.generation_cfg.eos_token_id
        results = []
        for row in out.tolist():
            if eos in row:
                row = row[:row.index(eos)]
            results.append(self.tokenizer.decode(row))
        return results
