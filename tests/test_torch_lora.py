"""Multi-tenant LoRA in the port against the JAX package: the config's
validation, the adapter banks and their init, the grouped delta against
the JAX grouped delta (Pallas in interpret mode) and the gather-einsum
plain version, the mixed-adapter forward, the converter's ``*_lora``
leaves, the canonical adapter trees, adapter checkpoints in both
directions and ``AdapterCache`` (ports of ``tests/test_lora.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    CPU, build_pair, jax_counters, numpy_tree, rng, tiny_kwargs,
)
from paddlefleetx_tpu.core import adapters as jax_adapters
from paddlefleetx_tpu.core import checkpoint as jax_ckpt
from paddlefleetx_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddlefleetx_tpu.models.gpt.generation import _unstack_layer_params
from paddlefleetx_tpu.ops import lora as jax_lora
from paddlefleetx_tpu_torch.core.adapters import (
    AdapterCache, AdapterCacheFull, extract_adapter, insert_adapter,
)
from paddlefleetx_tpu_torch.core.checkpoint import (
    MANIFEST_NAME, CheckpointCorrupt, load_adapter, save_adapter,
)
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.convert import (
    flax_from_torch_state_dict, torch_state_dict_from_flax,
)
from paddlefleetx_tpu_torch.models.gpt.model import LoRADelta, build_model
from paddlefleetx_tpu_torch.observability import metrics
from paddlefleetx_tpu_torch.ops.lora import (
    fallback_lora_delta, grouped_lora_delta,
)

LORA = dict(lora_rank=4, lora_num_adapters=3)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PFX_PALLAS_INTERPRET", "1")


def _tint(model, seed=0, std=0.2):
    """Give every ``lora_b`` bank a seeded non-zero value (a fresh bank
    is a zero delta), in place; returns the model's state dict."""
    g = rng(seed)
    sd = model.state_dict()
    for k in sd:
        if k.endswith("lora_b"):
            sd[k] = torch.from_numpy(
                g.normal(0.0, std, sd[k].shape).astype(np.float32)).to(
                sd[k].dtype)
    model.load_state_dict(sd)
    return sd


@pytest.fixture(scope="module")
def tinted():
    """A 2-layer LoRA pair with tinted banks: ``(jax_model,
    jax_params, port_model)`` on the same weights (the port's seeded
    weights carried into the JAX layout)."""
    kw = tiny_kwargs(**LORA)
    model = build_model(GPTConfig(**kw), CPU, seed=0)
    sd = _tint(model)
    return (JaxGPT(JaxGPTConfig(**kw)),
            flax_from_torch_state_dict(sd, model.config), model)


def _jit_apply(module, params, *args, **kwargs):
    """``module.apply`` under ``jax.jit`` (interpret-mode kernels trace
    once instead of running op by op)."""
    fn = jax.jit(lambda p, a, k: module.apply({"params": p}, *a, **k))
    return fn(params, args, kwargs)


# -- config --------------------------------------------------------------


@pytest.mark.parametrize("bad", [
    {"lora_rank": -1},
    {"lora_alpha": -1.0},
    {"lora_num_adapters": 3},
    {"lora_rank": 4, "lora_num_adapters": 1},
    {"lora_rank": 4, "lora_num_adapters": 3, "fuse_attn_qkv": False},
    {"lora_rank": 4, "lora_num_adapters": 3, "moe_num_experts": 4},
])
def test_config_refuses_what_jax_refuses(bad):
    kw = {"vocab_size": 64, "hidden_size": 32, "num_layers": 1,
          "num_attention_heads": 2, **bad}
    with pytest.raises(ValueError):
        JaxGPTConfig(**kw)
    with pytest.raises(ValueError):
        GPTConfig(**kw)


@pytest.mark.parametrize("knob", [
    {},
    {"lora_rank": 8, "lora_num_adapters": 5},
    {"lora_rank": 4, "lora_num_adapters": 2, "lora_alpha": 16.0},
])
def test_config_accepts_and_scales_like_jax(knob):
    kw = {"vocab_size": 64, "hidden_size": 32, "num_layers": 1,
          "num_attention_heads": 2, **knob}
    ours, theirs = GPTConfig(**kw), JaxGPTConfig(**kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.lora_scale == theirs.lora_scale


# -- banks ---------------------------------------------------------------


def test_knob_off_state_dict_unchanged():
    """``lora_rank`` 0 is the base model key for key; a LoRA model adds
    exactly the eight bank leaves of each layer, in the JAX layout, with
    ``lora_a`` drawn and ``lora_b`` zero."""
    base = build_model(GPTConfig(**tiny_kwargs()), CPU, seed=0).state_dict()
    off = build_model(GPTConfig(**tiny_kwargs(
        lora_rank=0, lora_num_adapters=0)), CPU, seed=0).state_dict()
    assert list(off) == list(base)
    for k in base:
        assert off[k].shape == base[k].shape and torch.equal(off[k], base[k])
    cfg = GPTConfig(**tiny_kwargs(**LORA))
    lora = build_model(cfg, CPU, seed=0).state_dict()
    extra = set(lora) - set(base)
    assert set(base) <= set(lora)
    assert len(extra) == 8 * cfg.num_layers
    h, f = cfg.hidden_size, cfg.ffn_hidden_size
    shapes = {"qkv_proj_lora": (h, 3 * h), "out_proj_lora": (h, h),
              "linear1_lora": (h, f), "linear2_lora": (f, h)}
    for key in extra:
        site, leaf = key.split(".")[-2:]
        k, n = shapes[site]
        if leaf == "lora_a":
            assert lora[key].shape == (3, k, 4)
            assert float(lora[key].abs().sum()) > 0
        else:
            assert lora[key].shape == (3, 4, n)
            assert float(lora[key].abs().sum()) == 0.0


# -- the grouped delta ---------------------------------------------------


@pytest.mark.parametrize("r", [4, 8])
def test_grouped_delta_equals_jax_and_plain(r):
    """The grouped GEMM pair equals the JAX grouped delta (its Pallas
    kernel in interpret mode) and the gather-einsum plain version, for
    mixed, duplicated and all-zero ids, fp32 within 1e-5."""
    g = rng(7)
    m, k, n, a = 6, 32, 24, 5
    x = g.normal(size=(m, k)).astype(np.float32)
    la = g.normal(size=(a, k, r)).astype(np.float32)
    lb = g.normal(size=(a, r, n)).astype(np.float32)
    jax_delta = jax.jit(jax_lora.grouped_lora_delta)
    for ids in ([1, 3, 1, 0, 4, 2], [2] * m, [0] * m):
        ids = np.asarray(ids, np.int32)
        want = np.asarray(jax_delta(jnp.asarray(x), jnp.asarray(ids),
                                    jnp.asarray(la), jnp.asarray(lb)))
        t = [torch.from_numpy(v) for v in (x, ids, la, lb)]
        got = grouped_lora_delta(*t)
        plain = fallback_lora_delta(*t)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5,
                                   atol=1e-5)


def test_grouped_delta_bf16_and_admission():
    """bf16 within 2e-2 of the JAX grouped delta; the JAX admission's
    refusals."""
    g = rng(8)
    x = g.normal(size=(5, 16)).astype(np.float32)
    la = (0.3 * g.normal(size=(3, 16, 8))).astype(np.float32)
    lb = (0.3 * g.normal(size=(3, 8, 32))).astype(np.float32)
    ids = np.asarray([2, 0, 1, 2, 1], np.int32)
    want = np.asarray(jax_lora.grouped_lora_delta(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(ids),
        jnp.asarray(la, jnp.bfloat16), jnp.asarray(lb, jnp.bfloat16)),
        np.float32)
    got = grouped_lora_delta(*(torch.from_numpy(v).to(torch.bfloat16)
                               for v in (x, la, lb)[:1]),
                             torch.from_numpy(ids),
                             *(torch.from_numpy(v).to(torch.bfloat16)
                               for v in (la, lb)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)
    x0 = torch.zeros((4, 8))
    i0 = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="wants"):
        grouped_lora_delta(x0[None], i0, torch.zeros((2, 8, 2)),
                           torch.zeros((2, 2, 8)))
    with pytest.raises(NotImplementedError, match="mismatch"):
        grouped_lora_delta(x0, i0, torch.zeros((2, 6, 2)),
                           torch.zeros((2, 2, 8)))


def test_delta_module_masks_row_zero_and_counts():
    """Id-0 rows get an exact zero delta whatever bank row 0 holds,
    ``adapter_ids=None`` computes nothing, and each call with ids counts
    one ``lora/grouped`` (never ``lora/fallback``)."""
    cfg = GPTConfig(**tiny_kwargs(**LORA))
    mod = LoRADelta(cfg, 16, 24)
    with torch.no_grad():
        mod.lora_a.normal_()
        mod.lora_b.normal_()
    x = torch.from_numpy(rng(3).normal(size=(3, 2, 16)).astype(np.float32))
    metrics.set_enabled(True)
    reg = metrics.get_registry()
    reg.reset()
    try:
        assert torch.equal(mod(x, None), torch.zeros(3, 2, 24))
        assert reg.counter("lora/grouped") == 0
        d = mod(x, torch.tensor([0, 2, 1]))
        assert reg.counter("lora/grouped") == 1
        assert reg.counter("lora/fallback") == 0
    finally:
        reg.reset()
        metrics.set_enabled(False)
    assert torch.equal(d[0], torch.zeros(2, 24))
    want = fallback_lora_delta(x[1], torch.tensor([2, 2]), mod.lora_a,
                               mod.lora_b)
    np.testing.assert_allclose(d[1].detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


# -- the model -----------------------------------------------------------


def test_id0_rows_equal_the_base_model(tinted):
    """Adapter id 0 reproduces the base model exactly: the LoRA model
    with all-zero ids and with no ids equals the same weights without
    banks, bit for bit."""
    _, _, model = tinted
    base_cfg = dataclasses.replace(model.config, lora_rank=0,
                                   lora_num_adapters=0)
    sd = {k: v for k, v in model.state_dict().items() if "_lora." not in k}
    base = build_model(base_cfg, CPU, state_dict=sd)
    ids = torch.from_numpy(rng(4).integers(0, 96, (3, 12)))
    with torch.no_grad():
        want = base(ids)
        assert torch.equal(model(ids, adapter_ids=torch.zeros(3)), want)
        assert torch.equal(model(ids), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixed_adapter_forward_equals_jax(tinted, dtype):
    """A whole forward with mixed ids equals the JAX model on the same
    weights (its grouped Pallas kernel in interpret mode): fp32 within
    1e-5, bf16 within 2e-2; and a layer alone, fp32."""
    jmodel, params, model = tinted
    ids = rng(5).integers(0, 96, (4, 10))
    aid = np.asarray([0, 1, 2, 1], np.int32)
    if dtype == "bfloat16":
        cfg = dataclasses.replace(model.config, dtype="bfloat16")
        jmodel = type(jmodel)(JaxGPTConfig(**dataclasses.asdict(cfg)))
        model = build_model(cfg, CPU, state_dict=model.state_dict())
    with jax_counters() as reg:
        ref = _jit_apply(jmodel, params, jnp.asarray(ids, jnp.int32),
                         adapter_ids=jnp.asarray(aid))
        assert reg.counter("lora/grouped") == 4 * 2
        assert reg.counter("lora/fallback") == 0
    with torch.no_grad():
        got = model(torch.from_numpy(ids), adapter_ids=torch.from_numpy(aid))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol)
    if dtype == "float32":
        from paddlefleetx_tpu.models.gpt.model import (
            TransformerDecoderLayer as JaxLayer,
        )
        x = rng(6).normal(size=(4, 10, 128)).astype(np.float32)
        jl = JaxLayer(jmodel.config)
        want = _jit_apply(jl, params["gpt"]["decoder_1"], jnp.asarray(x),
                          adapter_ids=jnp.asarray(aid))
        with torch.no_grad():
            out = model.gpt.decoder[1](torch.from_numpy(x),
                                       adapter_ids=torch.from_numpy(aid))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("scanned", [False, True])
def test_converter_round_trip_with_lora_leaves(scanned):
    """The JAX tree with ``*_lora`` leaves, scanned or unrolled, comes
    back bit for bit through the port's state dict."""
    jmodel, params, model = build_pair(1, scan_layers=scanned, **LORA)
    params = numpy_tree(params)
    sd = torch_state_dict_from_flax(params, model.config)
    assert sum("_lora." in k for k in sd) == 16
    back = flax_from_torch_state_dict(sd, model.config)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf)
    lora = [jax.tree_util.keystr(p) for p, _ in flat if "_lora" in
            jax.tree_util.keystr(p)]
    assert len(lora) == (8 if scanned else 16)


# -- adapter trees -------------------------------------------------------


def _source(model, std=0.2):
    shapes = {k: tuple(v.shape) for k, v in extract_adapter(model, 0).items()}

    def source(aid):
        if int(aid) >= 90:
            raise KeyError(aid)
        g = rng(1000 + int(aid))
        return {k: g.normal(0.0, std, s).astype(np.float32)
                for k, s in shapes.items()}
    return source


def test_extract_insert_round_trip_across_layouts(tinted):
    """A tree the JAX package extracts from its scanned layout inserts
    into the port's bank and reads back equal; the port's extract
    inserts into the JAX unrolled layout; other rows stay untouched."""
    _, _, model = tinted
    model = build_model(model.config, CPU, state_dict=model.state_dict())
    jparams = jax.tree.map(jnp.asarray, flax_from_torch_state_dict(
        model.state_dict(), dataclasses.replace(model.config,
                                                scan_layers=True)))
    tree = _source(model)(5)
    jtree = numpy_tree(jax_adapters.extract_adapter(
        jax_adapters.insert_adapter(jparams, tree, 2), 2))
    row1 = extract_adapter(model, 1)
    insert_adapter(model, jtree, 2)
    out = extract_adapter(model, 2)
    assert set(out) == set(tree) and len(out) == 8
    for key in tree:
        np.testing.assert_array_equal(out[key].numpy(), tree[key])
        assert torch.equal(extract_adapter(model, 1)[key], row1[key])
    unrolled = _unstack_layer_params(jparams, model.config.num_layers)
    back = jax_adapters.extract_adapter(jax_adapters.insert_adapter(
        unrolled, {k: v.numpy() for k, v in out.items()}, 1), 1)
    for key in tree:
        np.testing.assert_array_equal(np.asarray(back[key]), tree[key])


def test_insert_refuses_chimeras(tinted):
    """Partial, misshapen or foreign trees are refused before anything
    is written; out-of-range rows and bankless models too."""
    _, _, model = tinted
    tree = _source(model)(4)
    before = extract_adapter(model, 1)
    partial = dict(tree)
    partial.pop("linear1_lora/lora_a")
    with pytest.raises(ValueError, match="missing"):
        insert_adapter(model, partial, 1)
    bad = dict(tree)
    bad["linear2_lora/lora_b"] = bad["linear2_lora/lora_b"][:, :2]
    with pytest.raises(ValueError, match="does not fit"):
        insert_adapter(model, bad, 1)
    extra = dict(tree)
    extra["mystery_lora/lora_a"] = tree["qkv_proj_lora/lora_a"]
    with pytest.raises(ValueError, match="matched no bank"):
        insert_adapter(model, extra, 1)
    for key, val in extract_adapter(model, 1).items():
        assert torch.equal(val, before[key])
    with pytest.raises(ValueError, match="out of range"):
        extract_adapter(model, 3)
    with pytest.raises(ValueError, match="no LoRA banks"):
        extract_adapter(torch.nn.Linear(4, 4), 0)


# -- adapter checkpoints -------------------------------------------------


def test_adapter_checkpoints_cross_packages(tmp_path, tinted):
    """The port saves what the JAX package loads and loads what it
    saves, leaves and meta bit for bit; a torn write is refused."""
    _, _, model = tinted
    tree = _source(model)(7)
    ours = tmp_path / "ours"
    save_adapter(str(ours), {k: torch.from_numpy(v) for k, v in
                             tree.items()}, meta={"adapter": 7, "rank": 4})
    got, meta = jax_ckpt.load_adapter(str(ours))
    assert meta == {"adapter": 7, "rank": 4} and set(got) == set(tree)
    theirs = tmp_path / "theirs"
    jax_ckpt.save_adapter(str(theirs), tree, meta={"adapter": 7})
    back, meta = load_adapter(str(theirs))
    assert meta == {"adapter": 7}
    for key in tree:
        np.testing.assert_array_equal(got[key], tree[key])
        np.testing.assert_array_equal(back[key], tree[key])
    (ours / MANIFEST_NAME).unlink()
    with pytest.raises(CheckpointCorrupt, match="manifest"):
        load_adapter(str(ours))
    with pytest.raises(ValueError, match="empty"):
        save_adapter(str(tmp_path / "none"), {})


# -- AdapterCache ----------------------------------------------------------


def _tiny_source(aid):
    if int(aid) >= 90:
        raise KeyError(aid)
    return {"qkv_proj_lora/lora_a": np.full((2, 4, 2), float(aid))}


def test_cache_hit_miss_refcounts():
    cache = AdapterCache(4, _tiny_source)      # rows 1..3 usable
    l1 = cache.acquire(11)
    assert l1.row == 1 and l1.tree is not None and l1.evicted is None
    l2 = cache.acquire(11)
    assert l2.row == 1 and l2.tree is None      # a warm hit, no reload
    assert cache.refcount(11) == 2
    assert cache.stats == {"adapter_hits": 1, "adapter_misses": 1,
                           "adapter_evictions": 0}
    cache.release(11)
    assert cache.refcount(11) == 1 and cache.is_resident(11)
    cache.release(11)
    assert cache.refcount(11) == 0 and cache.is_resident(11)
    cache.check()


def test_cache_lru_eviction_order():
    cache = AdapterCache(3, _tiny_source)      # 2 usable rows
    cache.acquire(1)
    cache.acquire(2)
    cache.release(1)                            # 1 is released first
    cache.release(2)
    lease = cache.acquire(3)                    # evicts 1
    assert lease.evicted == 1 and lease.tree is not None
    assert sorted(cache.resident_ids()) == [2, 3]
    assert cache.acquire(2).tree is None        # 2 kept its row
    assert cache.stats["adapter_evictions"] == 1
    cache.check()


def test_cache_pinned_rows_never_evicted():
    cache = AdapterCache(3, _tiny_source)
    cache.acquire(1)
    cache.acquire(2)                            # both rows pinned
    with pytest.raises(AdapterCacheFull):
        cache.acquire(3)
    assert sorted(cache.resident_ids()) == [1, 2]
    assert cache.refcount(1) == 1 and cache.refcount(2) == 1
    assert not cache.can_admit(3)
    cache.release(2)
    assert cache.can_admit(3)
    assert cache.acquire(3).evicted == 2
    assert cache.refcount(1) == 1
    cache.check()


def test_cache_unknown_id_does_not_evict():
    """The source loads before any eviction: an unknown id costs no
    resident its row."""
    cache = AdapterCache(2, _tiny_source)       # 1 usable row
    cache.acquire(5)
    cache.release(5)
    with pytest.raises(KeyError):
        cache.acquire(99)
    assert cache.resident_ids() == [5]
    assert cache.stats["adapter_evictions"] == 0
    cache.check()


def test_cache_release_errors():
    cache = AdapterCache(3, _tiny_source)
    with pytest.raises(KeyError, match="non-resident"):
        cache.release(1)
    cache.acquire(1)
    cache.release(1)
    with pytest.raises(AssertionError, match="underflow"):
        cache.release(1)
    with pytest.raises(ValueError, match="num_rows"):
        AdapterCache(1, _tiny_source)
