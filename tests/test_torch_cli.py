"""The port's entry points on a cut-down 345M recipe, on the CPU:
``generate`` returns text, ``serve`` runs the server to completion and
reports its summary; the module takes a state_dict or a seed."""

import os

import torch

from paddlefleetx_tpu_torch import cli
from paddlefleetx_tpu_torch.models.gpt.modules import GPTGenerationModule
from paddlefleetx_tpu_torch.utils.config import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                      "generation_gpt_345M_single_card.yaml")
TINY = ["Model.num_layers=2", "Model.hidden_size=128",
        "Model.num_attention_heads=2", "Model.ffn_hidden_size=256",
        "Model.vocab_size=300", "Model.max_position_embeddings=64",
        "Generation.max_dec_len=4"]


def _argv(*extra):
    out = ["-c", CONFIG, "--device", "cpu"]
    for o in TINY:
        out += ["-o", o]
    return out + list(extra)


def test_generate_main_returns_text():
    text = cli.generate_main(_argv("--text", "Historia est vitae"))
    assert isinstance(text, str)


def test_serve_main_runs_to_completion():
    summary = cli.serve_main(_argv("--requests", "3", "--slots", "2",
                                   "--max-prompt-len", "20"))
    assert summary["admitted"] == summary["evicted"] == 3
    assert set(summary["finish_reasons"]) <= {"eos", "length"}
    assert all(5 <= n <= 20 for n in summary["prompt_lens"])
    assert summary["decode_tokens"] > 0
    assert cli.main(["serve", *_argv("--requests", "1")]) == 0


def test_module_takes_seed_or_state_dict():
    cfg = get_config(CONFIG, TINY)
    a = GPTGenerationModule(cfg, device="cpu")
    b = GPTGenerationModule(get_config(CONFIG, TINY), device="cpu",
                            state_dict=a.model.state_dict())
    c = GPTGenerationModule(get_config(CONFIG, TINY + ["Global.seed=5"]),
                            device="cpu")
    w = "gpt.decoder.0.linear1.weight"
    assert torch.equal(a.model.state_dict()[w], b.model.state_dict()[w])
    assert not torch.equal(a.model.state_dict()[w], c.model.state_dict()[w])
    assert a.model.word_embeddings.dtype == torch.bfloat16   # recipe: bf16
    assert a.generation_cfg.eos_token_id == a.tokenizer.eos_token_id
    assert a.generate(["abc", "de"]) == b.generate(["abc", "de"])


def test_train_main_runs_on_a_synthetic_corpus(tmp_path):
    """``train`` on the 345M pretraining recipe cut to a tiny size, on
    the CPU; it saves, and a second call resumes from the checkpoint."""
    from paddlefleetx_tpu_torch.data.synthetic import write_corpus
    write_corpus(str(tmp_path / "data"), 300, 20000, seed=2)
    cfg = os.path.join(ROOT, "configs", "nlp", "gpt",
                       "pretrain_gpt_345M_single_card.yaml")
    over = ["Model.num_layers=2", "Model.hidden_size=128",
            "Model.num_attention_heads=2", "Model.ffn_hidden_size=256",
            "Model.vocab_size=300", "Model.max_position_embeddings=64",
            "Global.local_batch_size=2", "Global.micro_batch_size=2",
            "Engine.max_steps=2", "Engine.eval_freq=2", "Engine.eval_iters=1",
            "Engine.save_load.save_steps=1",
            f"Engine.save_load.output_dir={tmp_path / 'out'}"]
    for mode in ("Train", "Eval"):
        over += [f"Data.{mode}.dataset.input_dir={tmp_path / 'data'}",
                 f"Data.{mode}.dataset.max_seq_len=64",
                 f"Data.{mode}.dataset.eos_id=299"]
    argv = ["-c", cfg, "--device", "cpu"]
    for o in over:
        argv += ["-o", o]
    engine = cli.train_main(argv)
    assert engine.step == 2 and len(engine.history) == 2
    assert engine.module.model_config.dtype == "bfloat16"   # the recipe
    assert engine.model.word_embeddings.dtype == torch.float32
    resumed = cli.train_main(argv + [
        "-o", f"Engine.save_load.ckpt_dir={tmp_path / 'out'}",
        "-o", "Engine.max_steps=3"])
    assert resumed.step == 3 and len(resumed.history) == 1
