"""Weight-only int8 PTQ parity: the port's ``core/quantize.py`` makes the
JAX package's int8 values and fp32 scales bit for bit (its
``quantize_param_tree`` carried through the converter), the converter
carries quantized trees both ways, the dequantized tree matches, and a
quantized model keeps its scales fp32 whatever its compute dtype."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_parity import (
    CPU, jax_params, numpy_tree, tiny_kwargs,
)
from paddlefleetx_tpu.core.quantize import (
    dequantize_param_tree, quantize_param_tree,
)
from paddlefleetx_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddlefleetx_tpu_torch.core import quantize as port_q
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.convert import (
    flax_from_torch_state_dict, torch_state_dict_from_flax,
)
from paddlefleetx_tpu_torch.models.gpt.model import QuantLinear, build_model

SITES = ("qkv_proj", "out_proj", "linear1", "linear2")


@pytest.fixture(scope="module", params=[False, True],
                ids=["unrolled", "scanned"])
def trees(request):
    """The JAX fp params of a tiny GPT (scanned or unrolled), their
    ``quantize_param_tree`` and its report, and the port config."""
    kw = tiny_kwargs(scan_layers=request.param, ffn_hidden_size=256)
    params = numpy_tree(jax_params(JaxGPT(JaxGPTConfig(**kw)), 3))
    qparams, report = quantize_param_tree(params)
    return params, numpy_tree(qparams), report, GPTConfig(**kw)


def test_port_ptq_equals_jax_bit_for_bit(trees):
    """``quantize_state_dict`` of the converted fp tree equals the JAX
    quantized tree converted: every int8 weight and fp32 scale, bit
    for bit, and the report has the JAX rows."""
    params, qparams, report, cfg = trees
    ours, our_report = port_q.quantize_state_dict(
        torch_state_dict_from_flax(params, cfg))
    theirs = torch_state_dict_from_flax(qparams, cfg)
    assert set(ours) == set(theirs)
    scales = [k for k in ours if k.endswith(".weight_scale")]
    assert len(scales) == 4 * cfg.num_layers
    for key, t in ours.items():
        assert t.dtype == theirs[key].dtype, key
        assert torch.equal(t, theirs[key]), key
    for key in scales:
        assert ours[key].dtype == torch.float32
        assert ours[key[:-len("_scale")]].dtype == torch.int8
    # the JAX report has one row per site of a scanned stack
    assert len(our_report) == 4 * cfg.num_layers
    assert len(report) == 4 * (1 if cfg.scan_layers else cfg.num_layers)
    assert {r["path"].split(".")[-2] for r in our_report} == set(SITES)
    assert sum(r["bytes_int8"] for r in our_report) == \
        sum(r["bytes_int8"] for r in report)
    assert sum(r["bytes_fp"] for r in our_report) == \
        sum(r["bytes_fp"] for r in report)


def test_dequantize_round_trip(trees):
    """The dequantized state dict equals the JAX dequantized tree, and
    every weight lies within half a scale step of its fp source."""
    params, qparams, _, cfg = trees
    q = torch_state_dict_from_flax(qparams, cfg)
    ours = port_q.dequantize_state_dict(q)
    theirs = torch_state_dict_from_flax(
        numpy_tree(dequantize_param_tree(qparams)), cfg)
    fp = torch_state_dict_from_flax(params, cfg)
    assert set(ours) == set(theirs) == set(fp)
    for key, t in ours.items():
        assert torch.equal(t, theirs[key]), key
        if key + "_scale" in q:
            step = q[key + "_scale"][:, None]
            assert bool(((t - fp[key]).abs() <= step / 2 + 1e-12).all())


def test_converter_both_ways_on_quantized_trees(trees):
    """torch -> JAX -> torch and JAX -> torch -> JAX are bit-exact on a
    quantized tree; the qkv scale is ``[3, nh, hd]`` on the JAX side
    and ``[3 nh hd]`` here."""
    _, qparams, _, cfg = trees
    sd = torch_state_dict_from_flax(qparams, cfg)
    assert sd["gpt.decoder.0.self_attn.qkv_proj.weight_scale"].shape == \
        (3 * cfg.hidden_size,)
    back = flax_from_torch_state_dict(sd, cfg)
    flat = traverse_util.flatten_dict(qparams)
    got = traverse_util.flatten_dict(back)
    assert set(got) == set(flat)
    for key, v in flat.items():
        assert got[key].dtype == v.dtype and got[key].shape == v.shape, key
        np.testing.assert_array_equal(got[key], v)
    again = torch_state_dict_from_flax(back, cfg)
    assert all(torch.equal(again[k], sd[k]) for k in sd)


def test_build_model_keeps_scales_fp32_under_bf16():
    """``build_model`` quantizes the seed's fp32 weights before the cast
    to bf16; the int8 weights stay int8 and the scales fp32 (also
    after a further ``.to`` / ``.half()``), as the JAX scales are."""
    kw = tiny_kwargs(quant_execution="weight_only_int8", dtype="bfloat16")
    cfg = GPTConfig(**kw)
    model = build_model(cfg, CPU, seed=5)
    fp = build_model(dataclasses.replace(cfg, quant_execution="off",
                                         dtype="float32"), CPU, seed=5)
    want, _ = port_q.quantize_state_dict(fp.state_dict())
    sites = [m for m in model.modules() if isinstance(m, QuantLinear)]
    assert len(sites) == 4 * cfg.num_layers
    for name, t in model.state_dict().items():
        if name.endswith(".weight_scale"):
            assert t.dtype == torch.float32
            assert torch.equal(t, want[name])
        elif name.endswith(".weight") and want[name].dtype == torch.int8:
            assert t.dtype == torch.int8 and torch.equal(t, want[name])
        else:
            assert t.dtype == torch.bfloat16, name
    model.half()
    model.to(torch.float32)
    assert all(m.weight_scale.dtype == torch.float32 for m in sites)
    assert all(m.weight.dtype == torch.int8 for m in sites)
    assert sites[0].bias.dtype == torch.float32
    # an fp state dict given to a quantized config is quantized the same
    again = build_model(cfg, CPU, state_dict=fp.state_dict())
    for name, t in again.state_dict().items():
        if name.endswith(".weight_scale") or t.dtype == torch.int8:
            assert torch.equal(t, want[name]), name


def test_training_under_quant_execution_raises():
    cfg = GPTConfig(**tiny_kwargs(quant_execution="weight_only_int8"))
    with pytest.raises(NotImplementedError, match="int8 leaves"):
        build_model(cfg, CPU, train=True)


def test_quantize_kernel_matches_jax_on_edge_rows():
    """A zero row (scale clamped at 1e-8, all zeros back), a row whose
    abs-max sits on a rounding tie, and a negative abs-max: the same
    int8 values and scales as the JAX ``quantize_kernel``."""
    from paddlefleetx_tpu.core.quantize import quantize_kernel
    w = np.zeros((4, 256), np.float32)          # [N, K]
    w[1, :3] = [2.54, -1.27, 0.635]
    w[2] = np.linspace(-3.0, 1.0, 256)
    w[3, 7] = 1e-12
    q, s = port_q.quantize_kernel(torch.from_numpy(w))
    jq, js = quantize_kernel(jnp.asarray(w.T), 1, 2)   # JAX [K, N]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[0]) == pytest.approx(1e-8)
    assert not q[0].any()
