"""``GPTGenerationModule``: config -> model -> tokenizer -> generation
(the port's counterpart of the JAX package's
``models/gpt/modules.py::GPTGenerationModule``).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ...data.tokenizers.gpt_tokenizer import GPTTokenizer
from ...utils.device import resolve_device
from ..language_utils import process_model_configs
from .config import GPTConfig
from .generation import GenerationConfig, generate, left_pad_batch
from .model import build_model


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
