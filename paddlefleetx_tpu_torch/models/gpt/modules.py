"""GPT task modules (the port's counterparts of the JAX package's
``models/gpt/modules.py``): ``GPTModule`` (the training module: model,
loss, step lines) and ``GPTGenerationModule`` (config -> model ->
tokenizer -> generation).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch

from ...core.module import LanguageModule
from ...data.tokenizers.gpt_tokenizer import GPTTokenizer
from ...utils.device import resolve_device
from ..language_utils import process_configs, process_model_configs
from .config import GPTConfig
from .generation import GenerationConfig, generate, left_pad_batch
from .model import (
    build_model, chunked_lm_loss, compute_context, cross_entropy_loss,
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
        module's device; pipeline parallelism, MoE and QAT raise."""
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
        ``loss_chunks > 1`` the loss is chunked (``chunked_lm_loss``)."""
        tokens, position_ids, labels, loss_mask = batch
        cfg = self.model_config
        drop = train and (cfg.hidden_dropout_prob > 0.0 or
                          cfg.attention_probs_dropout_prob > 0.0)
        dropout_seed = int(seed) if drop else None
        with compute_context(cfg, tokens.device):
            if cfg.loss_chunks > 1:
                return chunked_lm_loss(model, tokens, labels, loss_mask,
                                       cfg.loss_chunks, position_ids,
                                       dropout_seed)
            logits = model(tokens, position_ids, dropout_seed=dropout_seed)
            return cross_entropy_loss(logits, labels, loss_mask)

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
