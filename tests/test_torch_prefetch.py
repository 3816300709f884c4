"""``Engine._prefetch_iter`` and ``Engine.prefetch_depth`` of the port,
mirroring the JAX engine's tests (``tests/test_engine.py``, input
prefetch): batch N + depth is staged before batch N is handed out, in
the loader's order, with the same interleaving of stagings and hand-outs
as the JAX engine's iterator on the same fake host; depth 0 stages each
batch when it is asked for; a loader shorter than the depth drains;
``fit`` records one ``h2d_wait`` a step; prefetch 0 and prefetch 2
train loss for loss the same. On the card (marked ``cuda``): the staged
batch comes from pinned host memory over the copy stream and equals the
synchronous copy. The JAX package is imported inside the tests that
hold the port to it, so this file also runs on the card without it."""

import numpy as np
import pytest
import torch

from _torch_engine_cfg import corpus, port_engine, tiny_over
from paddlefleetx_tpu_torch.core.engine import Engine, _Staged


class _FakeHost:
    """Just enough engine for ``_prefetch_iter``: records the
    interleaving of stagings (``_put_batch``) and hand-outs."""

    def __init__(self, events, depth):
        self.events = events
        self.prefetch_depth = depth

        class _Mod:
            @staticmethod
            def pretreating_batch(b):
                return b

        self.module = _Mod()

    def _put_batch(self, b):
        self.events.append(("put", b))
        return b


def _trace(prefetch_iter, depth, batches):
    events = []
    fake = _FakeHost(events, depth)
    got = []
    for batch, wait in prefetch_iter(fake, batches):
        assert wait >= 0.0
        events.append(("yield", batch))
        got.append(batch)
    return got, events


@pytest.mark.parametrize("depth,n", [(2, 4), (0, 3), (4, 2), (1, 5)])
def test_staging_order_matches_the_jax_engine(depth, n):
    """The port's and the JAX engine's iterators on the same fake host:
    the same batches and the same sequence of stagings and hand-outs."""
    from paddlefleetx_tpu.core.engine import Engine as JaxEngine
    batches = list(range(n))
    got, events = _trace(Engine._prefetch_iter, depth, batches)
    jgot, jevents = _trace(JaxEngine._prefetch_iter, depth, batches)
    assert got == jgot == batches
    assert events == jevents


def test_staging_runs_ahead_and_keeps_order():
    """Depth 2: batch N + 2 is staged before batch N is handed out."""
    got, events = _trace(Engine._prefetch_iter, 2, [0, 1, 2, 3])
    assert got == [0, 1, 2, 3]
    assert [b for e, b in events if e == "put"] == [0, 1, 2, 3]
    assert events.index(("put", 2)) < events.index(("yield", 0))
    assert events.index(("put", 3)) < events.index(("yield", 1))


def test_depth_zero_is_synchronous():
    """No batch is staged before the previous one is handed out."""
    _, events = _trace(Engine._prefetch_iter, 0, [0, 1, 2])
    assert events == [("put", 0), ("yield", 0), ("put", 1),
                      ("yield", 1), ("put", 2), ("yield", 2)]


def test_a_short_loader_drains():
    """A loader shorter than the depth yields every batch once."""
    got, _ = _trace(Engine._prefetch_iter, 4, [0, 1])
    assert got == [0, 1]


def test_fit_records_h2d_wait_per_step(tmp_path):
    """One ``h2d_wait`` sample a trained step (the summary's input-wait
    line and the ``step_window`` events read them), the first carrying
    the pipeline's fill; staged batches are device tensors."""
    over = tiny_over(corpus(tmp_path / "data"), str(tmp_path / "out"))
    cfg, engine, loader = port_engine(over)
    assert engine.prefetch_depth == 2    # the JAX engine's default
    staged = engine._put_batch(next(iter(loader)))
    assert isinstance(staged, _Staged) and staged.event is None
    assert all(isinstance(t, torch.Tensor) for t in staged)
    engine.fit(epoch=1, train_data_loader=loader)
    assert len(engine._h2d_waits) == cfg.Engine.max_steps
    assert all(w >= 0.0 for w in engine._h2d_waits)
    stats = engine.summary
    assert stats["h2d_fill_s"] == engine._h2d_waits[0]
    assert stats["bucket_h2d_s"] == pytest.approx(sum(engine._h2d_waits))


def test_prefetch_zero_and_two_train_the_same(tmp_path):
    """``prefetch_depth`` 0 (synchronous) and 2 give the same losses,
    bit for bit, over 6 steps with dropout: prefetch neither reorders
    nor drops a batch."""
    data = corpus(tmp_path / "data")
    losses = {}
    for depth in (2, 0):
        over = tiny_over(data, str(tmp_path / f"out{depth}"), **{
            "Engine.prefetch_depth": depth, "Engine.max_steps": 6,
            "Model.hidden_dropout_prob": 0.1,
            "Model.attention_probs_dropout_prob": 0.1})
        _, engine, loader = port_engine(over)
        assert engine.prefetch_depth == depth
        torch.manual_seed(0)
        engine.fit(epoch=1, train_data_loader=loader)
        losses[depth] = [h["loss"] for h in engine.history]
    assert len(losses[2]) == 6 and losses[2] == losses[0]


@pytest.mark.cuda
def test_staging_on_the_card_equals_the_synchronous_copy(tmp_path):
    """On the card a staged batch is copied from pinned host tensors on
    the copy stream and carries its event; the pinned tensors stay
    referenced until the event has passed; after the compute stream waits
    on it the batch equals the synchronous copy, and depth 2 trains the
    same losses as depth 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for pinned staging")
    from paddlefleetx_tpu_torch.core.engine import Engine as PortEngine
    from paddlefleetx_tpu_torch.data import build_dataloader
    from paddlefleetx_tpu_torch.models.gpt.modules import GPTModule
    from paddlefleetx_tpu_torch.utils.config import get_config
    from _torch_engine_cfg import CONFIG
    data = corpus(tmp_path / "data")
    losses = {}
    for depth in (2, 0):
        over = tiny_over(data, str(tmp_path / f"o{depth}"), **{
            "Engine.prefetch_depth": depth, "Engine.max_steps": 6})
        cfg = get_config(CONFIG, over)
        engine = PortEngine(cfg, GPTModule(cfg, device="cuda"),
                            device="cuda")
        loader = build_dataloader(cfg.Data, "Train")
        loader.batch_sampler.batch_size = cfg.Global.global_batch_size
        if depth:
            host = next(iter(loader))
            staged = engine._put_batch(host)
            assert staged.event is not None
            assert all(h.is_pinned() for h in engine._inflight[-1][1])
            got = engine._to_device(staged)
            for a, b in zip(got, host):
                assert torch.equal(a.cpu(), torch.from_numpy(np.asarray(b)))
        engine.fit(epoch=1, train_data_loader=loader)
        losses[depth] = [h["loss"] for h in engine.history]
    assert losses[2] == losses[0]
