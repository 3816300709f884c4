"""The attention-dropout mask of the port: Philox4x32-10 in plain PyTorch
(``ops/cuda/philox.py``, the same function as ``csrc/philox.cuh``)
against Random123's published known answers, its keep rate, its
independence from tiling, and the forward and backward seeing the same
mask. Also the hidden-dropout streams of the model."""

import numpy as np
import pytest
import torch

from _torch_parity import one_thread, rng
from paddlefleetx_tpu_torch.models.gpt.model import fold_seed, hidden_dropout
from paddlefleetx_tpu_torch.ops.cuda import flash_attention as fa
from paddlefleetx_tpu_torch.ops.cuda import philox

# Random123 kat_vectors, philox4x32 with 10 rounds: counter, key, output
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    words = philox.philox4x32_10(*ctr, *key)
    assert tuple(int(w) for w in words) == want


def test_keep_rate_at_0_1():
    keep = philox.attention_keep_mask(1234, 0.1, 2, 2, 256, 256, "cpu")
    assert keep.shape == (2, 2, 256, 256)
    dropped = 1.0 - keep.float().mean().item()
    assert abs(dropped - 0.1) <= 0.005


def test_rate_zero_is_exactly_the_no_dropout_output():
    q, k, v = (torch.from_numpy(rng(i).standard_normal(
        (2, 40, 2, 64)).astype(np.float32)) for i in range(3))
    with one_thread():
        plain, plain_lse = fa.flash_attention(q, k, v)
        zero, zero_lse = fa.flash_attention(q, k, v, dropout_rate=0.0,
                                            seed=5)
        dropped, dropped_lse = fa.flash_attention(q, k, v,
                                                  dropout_rate=0.1, seed=5)
    assert torch.equal(plain, zero) and torch.equal(plain_lse, zero_lse)
    assert not torch.equal(plain, dropped)
    # the normaliser sums the undropped probabilities
    assert torch.equal(plain_lse, dropped_lse)


@pytest.mark.parametrize("tile", [64, 128])
def test_mask_is_the_same_built_whole_or_by_tiles(tile):
    seed, rate, b, h, s = 77, 0.1, 1, 3, 256
    whole = philox.attention_keep_mask(seed, rate, b, h, s, s, "cpu")
    bh = torch.arange(b * h)
    tiled = torch.empty_like(whole).reshape(b * h, s, s)
    for r0 in range(0, s, tile):
        for c0 in range(0, s, tile):
            tiled[:, r0:r0 + tile, c0:c0 + tile] = philox.keep_mask(
                seed, rate, bh, r0, tile, c0, tile)
    assert torch.equal(tiled.reshape(whole.shape), whole)
    # an unaligned window reads the same bits
    part = philox.keep_mask(seed, rate, bh[1:2], 5, 7, 3, 9)
    assert torch.equal(part[0], whole[0, 1, 5:12, 3:12])


def test_forward_and_backward_see_the_same_mask():
    """Central finite differences of the plain forward (dropout on)
    match the plain backward (fp64)."""
    b, s, h, d = 1, 9, 1, 8
    r = rng(4)
    q, k, v, g = (torch.from_numpy(r.standard_normal((b, s, h, d)))
                  for _ in range(4))

    def f(qq, kk, vv):
        out, _ = fa.flash_attention(qq, kk, vv, dropout_rate=0.3, seed=11)
        return float((out * g).sum())

    out, lse = fa.flash_attention(q, k, v, dropout_rate=0.3, seed=11)
    grads = fa.flash_attention_backward(q, k, v, out, lse, g,
                                        dropout_rate=0.3, seed=11)
    eps = 1e-6
    for which, grad in enumerate(grads):
        args = [q, k, v]
        num = torch.zeros_like(grad)
        for idx in np.ndindex(*grad.shape):
            plus = [a.clone() for a in args]
            minus = [a.clone() for a in args]
            plus[which][idx] += eps
            minus[which][idx] -= eps
            num[idx] = (f(*plus) - f(*minus)) / (2 * eps)
        np.testing.assert_allclose(grad.numpy(), num.numpy(), atol=1e-6)


def test_hidden_dropout_streams():
    """Same seed, same mask; another site or step, another mask; rate 0
    or no seed leaves the input as it is."""
    x = torch.ones(4, 64, 32)
    a = hidden_dropout(x, 0.1, fold_seed(1, 2, 3))
    assert torch.equal(a, hidden_dropout(x, 0.1, fold_seed(1, 2, 3)))
    assert not torch.equal(a, hidden_dropout(x, 0.1, fold_seed(1, 2, 4)))
    assert not torch.equal(a, hidden_dropout(x, 0.1, fold_seed(2, 2, 3)))
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.01
    assert torch.allclose(a[a != 0], torch.full_like(a[a != 0], 1 / 0.9))
    assert hidden_dropout(x, 0.0, 5) is x and hidden_dropout(x, 0.1, None) is x
    assert 0 <= fold_seed(2 ** 64 - 1, 7) < 2 ** 63


def test_dense_path_drops_with_the_kernels_mask():
    """``use_flash_attention: False`` applies the same Philox mask, so the
    dense and kernel paths agree with dropout on (fp32)."""
    from paddlefleetx_tpu_torch.ops import attention as port_attn
    q, k, v = (torch.from_numpy(rng(20 + i).standard_normal(
        (2, 33, 2, 16)).astype(np.float32)) for i in range(3))
    want, _ = fa.flash_attention(q, k, v, dropout_rate=0.1, seed=8)
    got = port_attn.dot_product_attention(q, k, v, use_flash=False,
                                          dropout_rate=0.1, dropout_seed=8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    plain = port_attn.dot_product_attention(q, k, v, use_flash=False)
    assert not torch.allclose(got, plain)
