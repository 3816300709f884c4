"""The port's offline evaluation (``GPTEvalModule``, ``Engine.evaluate``
and ``cli eval``) against the JAX package's ``GPTEvalModule`` and
``eval_main`` on the same weights and files, on the CPU: the eval recipe
cut to 2 layers and hidden 128, fp32, dense and MoE (``sort_pallas``,
the 8x345M recipe's routing on 4 experts).

WikiText: each batch's NLL sum, and ``loss``, ``ppl`` and
``adjusted_ppl``, within ``RTOL`` of JAX's (the port sums the LM head
over ``loss_chunks`` sequence chunks, JAX over the whole row). LAMBADA:
``correct`` and ``acc`` equal to JAX's on a file whose rows the model
gets right and wrong by construction (a tiny BPE vocabulary in
``./gpt2`` makes each target one token; the right rows' targets are the
model's argmax with a clear margin). The JAX side runs its Pallas
kernels in interpret mode and its dispatch counters show they ran."""

import functools
import json
import os
import string

import jax
import numpy as np
import pytest
import torch

from _torch_parity import CPU, jax_counters, numpy_tree, rng
from paddlefleetx_tpu.core import Engine as JaxEngine
from paddlefleetx_tpu.data import build_dataloader as jax_build_dataloader
from paddlefleetx_tpu.models import build_module as jax_build_module
from paddlefleetx_tpu.utils.config import get_config as jax_get_config
from paddlefleetx_tpu_torch import cli
from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.data import build_dataloader
from paddlefleetx_tpu_torch.data.tokenizers.gpt_tokenizer import (
    GPTTokenizer, bytes_to_unicode,
)
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.convert import (
    torch_state_dict_from_flax,
)
from paddlefleetx_tpu_torch.models.gpt.model import build_model
from paddlefleetx_tpu_torch.models.gpt.modules import GPTEvalModule
from paddlefleetx_tpu_torch.observability import metrics
from paddlefleetx_tpu_torch.utils.config import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                           "eval_gpt_345M_single_card.yaml")
#: fp32 NLL sums and metrics: the same products summed in another order
RTOL = 1e-5
#: the eval recipe cut to a tiny size, fp32 (head_dim 64 and a multiple
#: of 128 keys: what the JAX flash kernel takes); the recipe's dropout,
#: recompute and loss_chunks 8 stay
TINY = ["Model.num_layers=2", "Model.hidden_size=128",
        "Model.num_attention_heads=2", "Model.ffn_hidden_size=256",
        "Model.vocab_size=300", "Model.max_position_embeddings=128",
        "Model.initializer_range=0.1", "Data.Train.dataset.max_seq_len=128",
        "Engine.mix_precision.use_pure_fp16=False",
        "Offline_Eval.max_seq_len=128", "Offline_Eval.batch_size=3",
        "Offline_Eval.overlapping_eval=32"]
#: the 8x345M recipe's routing on 4 experts
MOE = ["Model.moe_num_experts=4", "Model.moe_top_k=2",
       "Model.moe_capacity_factor=1.25", "Model.moe_dispatch=sort_pallas"]
#: LAMBADA rows right and wrong by construction
N_RIGHT, N_WRONG = 3, 5


def _over(path, cloze=False, extra=()):
    return TINY + [f"Offline_Eval.eval_path={path}",
                   f"Offline_Eval.cloze_eval={cloze}", *extra]


def _scores(module):
    """Record each batch's score as ``validation_step_end`` sees it."""
    got = []
    orig = module.validation_step_end

    def keep(log):
        got.append(log["loss"])
        orig(log)
    module.validation_step_end = keep
    return got


def _jax_eval(over, counter):
    """JAX ``GPTEvalModule`` through its engine: ``(metrics, batch
    scores, params)``, the dispatch ``counter`` seen fired."""
    jax.clear_caches()
    jcfg = jax_get_config(EVAL_CONFIG, list(over), nranks=1)
    jmod = jax_build_module(jcfg)
    with jax_counters() as reg:
        jeng = JaxEngine(jcfg, jmod, mode="eval", devices=jax.devices()[:1])
        scores = _scores(jmod)
        jeng.evaluate(epoch=0, valid_data_loader=jax_build_dataloader(
            jcfg.Data, "Eval"))
        assert reg.counter(counter) > 0
    return dict(jmod.metrics), scores, numpy_tree(jeng.state["params"])


def _state(over, params):
    cfg = get_config(EVAL_CONFIG, list(over))
    return torch_state_dict_from_flax(params, GPTConfig.from_config(cfg))


def _port_eval(over, state, counter):
    """The port's ``GPTEvalModule`` through its engine on the CPU:
    ``(metrics, batch scores, module)``, ``counter`` seen fired."""
    cfg = get_config(EVAL_CONFIG, list(over))
    module = GPTEvalModule(cfg, state_dict=state, device="cpu")
    engine = Engine(cfg, module, mode="eval", device="cpu")
    scores = _scores(module)
    reg = metrics.get_registry()
    metrics.set_enabled(True)
    reg.reset()
    try:
        engine.evaluate(epoch=0, valid_data_loader=build_dataloader(
            cfg.Data, "Eval"))
        assert reg.counter(counter) > 0
    finally:
        reg.reset()
        metrics.set_enabled(False)
    return dict(module.metrics), scores, module


def wiki_text(seed: int, words: int = 120) -> str:
    """Seeded WikiText-style text with the markup the detokenizer
    rewrites."""
    vocab = ["alpha", "river", "N", "'s", "@-@", ",", ".", "(", ")", "=",
             "valley", "\n", "stone", "of", "the"]
    return " ".join(rng(seed).choice(vocab, words).tolist())


@pytest.fixture(scope="module")
def interpret():
    """The JAX Pallas kernels in interpret mode for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PFX_PALLAS_INTERPRET", "1")
        yield


@pytest.fixture(scope="module")
def wiki(tmp_path_factory):
    path = tmp_path_factory.mktemp("wiki") / "wiki.valid.tokens"
    path.write_text(wiki_text(3))
    return str(path)


@functools.lru_cache(maxsize=None)
def _jax_lm(path, moe):
    return _jax_eval(_over(path, extra=MOE if moe else ()),
                     "moe/sort_pallas" if moe else "attention/flash")


@pytest.mark.parametrize("moe", [False, True])
def test_lm_eval_equals_jax(interpret, wiki, moe):
    """Each batch's NLL sum (the last batch short) and the perplexities
    within ``RTOL`` of the JAX module's on the same weights."""
    over = _over(wiki, extra=MOE if moe else ())
    want, jscores, params = _jax_lm(wiki, moe)
    got, scores, module = _port_eval(
        over, _state(over, params),
        "moe/sort_pallas" if moe else "attention/flash")
    assert module.model_config.loss_chunks == 8
    assert len(scores) == len(jscores) > 2
    np.testing.assert_allclose(scores, jscores, rtol=RTOL)
    assert set(got) == set(want) == {"loss", "ppl", "adjusted_ppl"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=RTOL), k
    assert module.num_tokenized_tokens > module.num_original_tokens > 100


def _write_vocab(dirname):
    """A BPE vocabulary of the 256 byte symbols, the 26 merges
    ``Ġa``..``Ġz`` (a space and a letter as one token) and the eos
    token, in ``dirname/gpt2``; returns its tokenizer."""
    chars = sorted(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    merges = ["#version: 0.2"]
    for letter in string.ascii_lowercase:
        vocab["Ġ" + letter] = len(vocab)
        merges.append("Ġ " + letter)
    vocab["<|endoftext|>"] = len(vocab)
    os.makedirs(os.path.join(dirname, "gpt2"), exist_ok=True)
    with open(os.path.join(dirname, "gpt2", "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(dirname, "gpt2", "merges.txt"), "w") as f:
        f.write("\n".join(merges))
    return GPTTokenizer(vocab, merges)


def _cloze_lines(model, tok, seq, seed):
    """LAMBADA lines for ``model``: ``N_RIGHT`` whose one-token target
    is the model's argmax after the prefix (top-2 gap over 1e-2 of the
    logit scale), then ``N_WRONG`` whose target is not; each prefix is
    scored in a row padded to ``seq`` with eos, as the evaluation
    batches it (an MoE row's capacity comes from its length)."""
    r = rng(seed)
    first = tok.encoder["Ġa"]
    right, wrong = [], []
    while len(right) < N_RIGHT or len(wrong) < N_WRONG:
        words = ["".join(r.choice(list(string.ascii_lowercase),
                                  int(r.integers(1, 5))))
                 for _ in range(int(r.integers(2, 7)))]
        prefix = " ".join(words)
        ids = tok.encode(prefix)
        row = ids + [tok.eos_token_id] * (seq - len(ids))
        with torch.no_grad():
            logits = model(torch.tensor([row]))[0, len(ids) - 1].float()
        top2 = torch.topk(logits, 2)
        pick = int(top2.indices[0])
        gap = float(top2.values[0] - top2.values[1])
        if first <= pick < first + 26 and len(right) < N_RIGHT and \
                gap > 1e-2 * float(logits.abs().max()):
            right.append(prefix + " " + chr(ord("a") + pick - first))
        elif not first <= pick < first + 26 and len(wrong) < N_WRONG:
            wrong.append(prefix + " " + r.choice(
                list(string.ascii_lowercase)))
    return [json.dumps({"text": t}) for t in right + wrong]


@pytest.mark.parametrize("moe", [False, True])
def test_cloze_eval_equals_jax(interpret, wiki, tmp_path, monkeypatch,
                              moe):
    """``correct`` and ``acc`` equal to JAX's, and to the count built
    into the file: the datasets of both packages read the vocabulary
    in ``./gpt2``. The weights are the LM test's (the same model
    section and seed)."""
    monkeypatch.chdir(tmp_path)
    tok = _write_vocab(str(tmp_path))
    path = str(tmp_path / "lambada_test.jsonl")
    over = _over(path, cloze=True, extra=MOE if moe else ())
    params = _jax_lm(wiki, moe)[2]
    state = _state(over, params)
    model = build_model(GPTConfig.from_config(get_config(EVAL_CONFIG, over)),
                        CPU, state_dict=state)
    with open(path, "w") as f:
        f.write("\n".join(_cloze_lines(model, tok, 128, 8 + moe)))
    counter = "moe/sort_pallas" if moe else "attention/flash"
    want, jscores, jparams = _jax_eval(over, counter)
    assert jax.tree_util.tree_all(jax.tree.map(
        np.array_equal, jparams, params))
    got, scores, module = _port_eval(over, state, counter)
    assert module.num_examples == N_RIGHT + N_WRONG
    assert scores == jscores
    assert got == want == {"acc": N_RIGHT / (N_RIGHT + N_WRONG),
                           "correct": float(N_RIGHT)}


def _argv(over, *extra):
    argv = ["-c", EVAL_CONFIG, "--device", "cpu"]
    for o in (*over, *extra):
        argv += ["-o", o]
    return argv


def test_cli_eval_gives_the_in_process_metrics(wiki, tmp_path):
    """``cli eval`` on the CPU gives the metrics of the module and
    engine built in process from the same seed; with
    ``Engine.save_load.ckpt_dir`` it gives those of the checkpoint's
    weights, not of its own seed; ``main`` runs it."""
    over = _over(wiki)
    cfg = get_config(EVAL_CONFIG, over)
    module = GPTEvalModule(cfg, device="cpu")
    engine = Engine(cfg, module, mode="eval", device="cpu")
    assert engine.optimizer is None
    engine.evaluate(0, build_dataloader(cfg.Data, "Eval"))
    assert cli.eval_main(_argv(over)) == module.metrics
    engine.output_dir = str(tmp_path / "ckpt")
    engine.save(0)
    other = cli.eval_main(_argv(over, "Global.seed=7"))
    assert other["loss"] != module.metrics["loss"]
    loaded = cli.eval_main(_argv(over, "Global.seed=7",
                                 f"Engine.save_load.ckpt_dir={tmp_path}"
                                 "/ckpt"))
    assert loaded == module.metrics
    assert cli.main(["eval", *_argv(over)]) == 0


def test_cli_eval_runs_the_recipe_in_bf16_and_train_refuses_it(wiki):
    """The recipe's bf16 on the CPU: finite metrics, ppl above 1;
    ``train`` still refuses every module but ``GPTModule``; without a
    card and without ``--device`` the entry point raises."""
    over = [o for o in _over(wiki) if "use_pure_fp16" not in o]
    got = cli.eval_main(_argv(over))
    assert np.isfinite(got["loss"]) and got["ppl"] > 1.0
    with pytest.raises(NotImplementedError, match="GPTEvalModule"):
        cli.train_main(_argv(over))
    if not torch.cuda.is_available():
        on_card = ["-c", EVAL_CONFIG]
        for o in over:
            on_card += ["-o", o]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.eval_main(on_card)
