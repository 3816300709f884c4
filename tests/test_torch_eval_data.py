"""The port's offline evaluation data (``data/dataset/gpt_dataset_eval.py``,
``gpt_eval_collate_fn`` and the registry of ``data/__init__.py``) against
the JAX package's on the same files: the WikiText detokenizer, every
field of every ``LM_Eval_Dataset`` window (several ``overlapping_eval``
values, ``max_seq_len`` among them) and ``Lambada_Eval_Dataset`` sample,
and the collated batches of the eval loader, the short last one
included."""

import json

import numpy as np
import pytest

from _torch_parity import rng
from paddlefleetx_tpu.data import build_dataloader as jax_build_dataloader
from paddlefleetx_tpu.data import gpt_eval_collate_fn as jax_collate
from paddlefleetx_tpu.data.dataset import gpt_dataset_eval as jax_eval
from paddlefleetx_tpu_torch.data import (
    build_dataloader, build_dataset, gpt_eval_collate_fn,
)
from paddlefleetx_tpu_torch.data.dataset import gpt_dataset_eval as port_eval
from paddlefleetx_tpu_torch.utils.config import AttrDict

#: words and the WikiText markup the detokenizer rewrites
WORDS = ["the", "river", "N", "'s", "@-@", "@,@", "@.@", ",", ".", ":",
         ";", "!", "?", "(", ")", "[", "]", "{", "}", '"', "'", "=",
         "s", "\n", chr(176), "1", "valley", "<unk>", "eos"]


def wiki_text(seed: int, n: int = 700) -> str:
    """Seeded WikiText-style text: words, markup and newlines."""
    return " ".join(rng(seed).choice(WORDS, n).tolist())


def lambada_lines(seed: int, n: int = 7):
    """Seeded LAMBADA-style JSONL lines, the last word repeated earlier
    in some (``rfind`` must take the last one)."""
    r = rng(seed)
    out = []
    for _ in range(n):
        words = r.choice(WORDS[:3] + ["hills", "road", "night"],
                         int(r.integers(3, 12))).tolist()
        out.append(json.dumps({"text": " ".join(words)}))
    return out


def test_detokenizer_equals_jax():
    for seed in range(6):
        text = wiki_text(seed, 300)
        assert port_eval.wikitext_detokenizer(text) == \
            jax_eval.wikitext_detokenizer(text)
    assert port_eval.wikitext_detokenizer(" = = H = = \n a @-@ b ") == \
        jax_eval.wikitext_detokenizer(" = = H = = \n a @-@ b ")


def _fields_equal(got, want):
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("overlap", [None, 1, 7, 16, 64])
def test_lm_windows_equal_jax(tmp_path, overlap):
    """Every window of the sliding LM dataset equals JAX's: tokens,
    the loss mask (only the last ``overlap`` targets of a later
    window; the eos pad and a real eos masked), the placeholder mask,
    positions, labels and the token counts."""
    path = tmp_path / "wiki.valid.tokens"
    path.write_text(wiki_text(1))
    port = port_eval.LM_Eval_Dataset(str(path), max_seq_len=64,
                                     overlapping_eval=overlap, split=[1],
                                     num_samples=9, mode="Eval")
    jax = jax_eval.LM_Eval_Dataset(str(path), max_seq_len=64,
                                   overlapping_eval=overlap)
    assert port.tokens == jax.tokens
    assert len(port) == len(jax) > 2
    assert port.num_original_tokens == jax.num_original_tokens == 700
    for i in range(len(jax)):
        _fields_equal(port[i], jax[i])
    last = port[len(port) - 1]
    assert (last[0] == port.pad_idx).any()          # padded with eos
    assert last[1][last[0] == port.pad_idx].sum() == 0


def test_lambada_samples_equal_jax(tmp_path):
    path = tmp_path / "lambada_test.jsonl"
    path.write_text("\n".join(lambada_lines(2)) + "\n\n")
    port = port_eval.Lambada_Eval_Dataset(str(path), max_seq_len=96,
                                          seed=3)
    jax = jax_eval.Lambada_Eval_Dataset(str(path), max_seq_len=96)
    assert len(port) == len(jax) == 7
    assert port.labels == jax.labels
    for i in range(len(jax)):
        _fields_equal(port[i], jax[i])
    assert port[0][5][0] == 7
    strict = port_eval.Lambada_Eval_Dataset._get_tokens
    tok = port_eval.GPTTokenizer()
    assert strict(tok, "a b a", strict=False) == \
        jax_eval.Lambada_Eval_Dataset._get_tokens(
            jax_eval.GPTTokenizer(), "a b a", strict=False)


def _eval_section(path, name, batch, seq=32, **dataset):
    return AttrDict({"Eval": AttrDict({
        "dataset": AttrDict({"name": name, "input_dir": str(path),
                             "max_seq_len": seq, "split": [949, 50, 1],
                             "num_samples": 80, "seed": 1024,
                             "mode": "Eval", **dataset}),
        "sampler": AttrDict({"name": "GPTBatchSampler",
                             "batch_size": batch, "shuffle": False,
                             "drop_last": False}),
        "loader": AttrDict({"num_workers": 1, "return_list": False,
                            "collate_fn": "gpt_eval_collate_fn"})})})


@pytest.mark.parametrize("cloze", [False, True])
def test_collated_batches_equal_jax(tmp_path, cloze):
    """The eval loaders built from one ``Data`` section (with the
    pretraining recipe's leftover keys) give JAX's batches, six fields
    each, the last one short."""
    if cloze:
        path = tmp_path / "lambada.jsonl"
        path.write_text("\n".join(lambada_lines(4, 11)))
        section = _eval_section(path, "Lambada_Eval_Dataset", 4, seq=96)
    else:
        path = tmp_path / "wiki.txt"
        path.write_text(wiki_text(5, 400))
        section = _eval_section(path, "LM_Eval_Dataset", 4,
                                overlapping_eval=8)
    got = list(build_dataloader(section, "Eval"))
    want = list(jax_build_dataloader(section, "Eval"))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        _fields_equal(a, b)
    n = len(build_dataset(section, "Eval"))
    assert n % 4 and got[-1][0].shape == (n % 4, 96 if cloze else 32)
    samples = [build_dataset(section, "Eval")[i] for i in range(3)]
    _fields_equal(gpt_eval_collate_fn(samples), jax_collate(samples))


def test_registry_takes_the_eval_names_and_refuses_the_rest(tmp_path):
    path = tmp_path / "wiki.txt"
    path.write_text(wiki_text(6, 100))
    section = _eval_section(path, "LM_Eval_Dataset", 2)
    assert isinstance(build_dataset(section, "Eval"),
                      port_eval.LM_Eval_Dataset)
    for name in ("BlendedGPTDataset", "ImageFolder"):
        section.Eval.dataset.name = name
        with pytest.raises(NotImplementedError, match=name):
            build_dataset(section, "Eval")
    section.Eval.dataset.name = "LM_Eval_Dataset"
    section.Eval.loader.collate_fn = "gpt_inference_collate_fn"
    with pytest.raises(NotImplementedError, match="collate"):
        build_dataloader(section, "Eval")
