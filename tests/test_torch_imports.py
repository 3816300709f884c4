"""The port stands alone: no JAX, no JAX package, no environment knobs,
and its entry points run on the card unless asked for the CPU.

The import check reads the sources (AST), not ``sys.modules``: the test
process imports JAX for the parity tests anyway.
"""

import ast
import importlib
import os
import re

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddlefleetx_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "paddlefleetx_tpu")
CONFIG = os.path.join(ROOT, "configs", "nlp", "gpt",
                      "generation_gpt_345M_single_card.yaml")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_jax_package():
    bad = []
    for path in _port_files():
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad, bad
    assert len(_port_files()) > 15


def test_port_reads_no_pfx_environment_knob():
    knob = re.compile(r"^PFX_[A-Z0-9_]+$")
    found = []
    for path in _port_files():
        tree = ast.parse(open(path, encoding="utf-8").read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and knob.match(node.value):
                found.append((os.path.relpath(path, ROOT), node.value))
    assert not found, found


def test_every_port_module_imports_without_cuda_toolchain():
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)
        if rel == "chip_smoke.py":
            continue
        name = rel[:-3].replace(os.sep, ".")
        if name.endswith(".__init__"):
            name = name[:-len(".__init__")]
        importlib.import_module(name)


def test_default_device_raises_without_cuda():
    from paddlefleetx_tpu_torch.utils.device import resolve_device
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_instead_of_running_on_cpu():
    from paddlefleetx_tpu_torch import cli
    from paddlefleetx_tpu_torch.models.gpt.modules import GPTGenerationModule
    from paddlefleetx_tpu_torch.utils.config import get_config
    tiny = ["-o", "Model.num_layers=1", "-o", "Model.hidden_size=64",
            "-o", "Model.num_attention_heads=1", "-o", "Model.vocab_size=300",
            "-o", "Model.ffn_hidden_size=64"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.generate_main(["-c", CONFIG, *tiny])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.serve_main(["-c", CONFIG, *tiny])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTGenerationModule(get_config(CONFIG, [o for o in tiny
                                                if o != "-o"]))


def test_cli_main_usage():
    from paddlefleetx_tpu_torch import cli
    assert cli.main([]) == 2
    assert cli.main(["train"]) == 2
