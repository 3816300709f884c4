"""The port's serving robustness surface against the JAX package's (the
counterparts of JAX ``tests/test_serving.py:1007-1335``), on the same
converted weights, in fp32: deadlines (queued and mid-decode), queue
shedding and an injected ``admit_fail``, ``resume_tokens`` validation,
drain -> restart token exactness (contiguous and paged, the stitched
rows equal to the JAX server's uninterrupted rows), the SIGTERM flip
and ``close()``, ``preempt(request_id)``, the event names and order of
a preemption timeline equal to the JAX server's, a trace continued
across a resume, the drain exit of the device loop, the prefix-store
round trip through ``save_prefix_store`` / ``load_prefix_store`` and
its refusals, and a ``/metrics`` + ``/healthz`` scrape on 127.0.0.1
that flips to 503 on drain."""

import json
import os
import re
import signal
import time
import urllib.error
import urllib.request
from contextlib import closing

import numpy as np
import pytest

from _torch_parity import build_pair
from paddlefleetx_tpu.core.resilience import \
    FaultInjector as JaxFaultInjector
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu.observability.recorder import \
    read_events as jax_read_events
from paddlefleetx_tpu_torch.core.checkpoint import (
    load_prefix_store, save_prefix_store,
)
from paddlefleetx_tpu_torch.core.resilience import FaultInjector
from paddlefleetx_tpu_torch.core.serving import GenerationServer, RequestShed
from paddlefleetx_tpu_torch.models.gpt import generation as gen
from paddlefleetx_tpu_torch.models.gpt.model import build_model
from paddlefleetx_tpu_torch.observability import metrics
from paddlefleetx_tpu_torch.observability import server as obs_server
from paddlefleetx_tpu_torch.observability.recorder import read_events

EOS = PAD = 95
PROMPTS = [[5, 9, 2, 7, 1], [11, 3], [4, 4, 8, 1, 2, 6, 9],
           [13, 2, 2], [1], [7, 8]]
PAGED = dict(page_size=128, pool_pages=24)


def cfg(cls=gen.GenerationConfig, max_dec=8):
    return cls(max_dec_len=max_dec, decode_strategy="greedy_search",
               eos_token_id=EOS, pad_token_id=PAD)


def drain_all(srv, done=None):
    done = {} if done is None else done
    while srv.pending or srv.occupancy:
        for c in srv.step():
            done[c.request_id] = c
    return done


@pytest.fixture(scope="module")
def ref():
    """The port model and the JAX server's uninterrupted greedy rows of
    ``PROMPTS`` (contiguous and paged)."""
    jmodel, params, model = build_pair(seed=7, max_position_embeddings=512)
    rows = {}
    for name, kw in (("contiguous", {}), ("paged", PAGED)):
        srv = JaxServer(jmodel, params, cfg(jax_gen.GenerationConfig),
                        num_slots=2, **kw)
        rows[name] = [c.tokens for c in srv.run(PROMPTS)]
        srv.close()
    assert rows["contiguous"] == rows["paged"]
    return {"model": model, "jmodel": jmodel, "params": params,
            "rows": rows["paged"]}


def test_deadline_exceeded_in_queue(ref):
    srv = GenerationServer(ref["model"], cfg(), num_slots=1)
    a = srv.submit(PROMPTS[0])
    b = srv.submit(PROMPTS[1], deadline_s=0.01)   # stuck behind a
    time.sleep(0.05)
    done = drain_all(srv)
    assert done[b].finish_reason == "deadline_exceeded"
    assert done[b].tokens == []
    assert done[a].tokens == ref["rows"][0]
    assert srv.summary()["deadline_exceeded"] == 1
    srv.close()


@pytest.mark.parametrize("paged", [False, True])
def test_deadline_exceeded_mid_decode_returns_partial(ref, paged):
    srv = GenerationServer(ref["model"], cfg(), num_slots=1,
                           request_ttl_s=3600.0, **(PAGED if paged else {}))
    a = srv.submit(PROMPTS[0])
    while not (srv._slots[0] and len(srv._slots[0]["tokens"]) >= 2):
        srv.step()
    srv._slots[0]["deadline"] = 1.0           # long expired
    (c,) = srv.step()
    assert c.request_id == a and c.finish_reason == "deadline_exceeded"
    assert c.tokens == ref["rows"][0][:2]     # the partial is kept
    assert srv.occupancy == 0
    srv.check_alloc()
    srv.close()


def test_queue_depth_shedding_and_injected_admit_fail(ref):
    srv = GenerationServer(ref["model"], cfg(), num_slots=1,
                           max_queue_depth=2)
    srv.submit(PROMPTS[0])
    srv.submit(PROMPTS[1])
    with pytest.raises(RequestShed, match="queue_depth"):
        srv.submit(PROMPTS[2])
    assert srv.summary()["shed"] == 1 and srv.pending == 2
    srv.close()
    got = {}
    spec = "admit_fail@req=2,admit_fail@req=p0.5"
    for name, make in (
            ("port", lambda: GenerationServer(
                ref["model"], cfg(), num_slots=1,
                fault_injector=FaultInjector(spec, seed=3,
                                             kill_mode="raise"))),
            ("jax", lambda: JaxServer(
                ref["jmodel"], ref["params"], cfg(jax_gen.GenerationConfig),
                num_slots=1, fault_injector=JaxFaultInjector(
                    spec, seed=3, kill_mode="raise")))):
        srv = make()
        shed = []
        for i, p in enumerate(PROMPTS):
            try:
                srv.submit(p)
            except RuntimeError as err:     # RequestShed in both
                assert "fault" in str(err)
                shed.append(i)
        got[name] = (shed, srv.summary()["shed"])
        srv.close()
    assert got["port"] == got["jax"] and 1 in got["port"][0]


def test_resume_tokens_validation(ref):
    srv = GenerationServer(ref["model"], cfg(max_dec=4), num_slots=1,
                           page_size=128, pool_pages=8,
                           prefill_chunk_pages=1)
    with pytest.raises(ValueError, match="max_dec_len"):
        srv.submit(PROMPTS[0], resume_tokens=[1, 2, 3, 4])
    srv.submit(PROMPTS[0], resume_tokens=[1, 2, 3])   # one left: fine
    srv.close()


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("loop_ticks", [1, 4])
def test_drain_restart_token_exactness(ref, paged, loop_ticks):
    """Drain mid-flight, feed every preempted partial into a FRESH
    server through ``resume_tokens``: the stitched completions equal
    the JAX server's uninterrupted rows, no token lost or replayed."""
    kw = dict(num_slots=2, device_loop_ticks=loop_ticks,
              **(PAGED if paged else {}))
    srv = GenerationServer(ref["model"], cfg(), **kw)
    ids = [srv.submit(p) for p in PROMPTS]
    done = {}
    for _ in range(3):
        for c in srv.step():
            done[c.request_id] = c
    for c in srv.drain(max_ticks=0):
        done[c.request_id] = c
    srv.close()
    assert set(done) == set(ids)
    partials = [c for c in done.values() if c.finish_reason == "preempted"]
    assert partials and any(c.tokens for c in partials)
    srv2 = GenerationServer(ref["model"], cfg(), **kw)
    remap = {srv2.submit(c.prompt, resume_tokens=c.tokens or None):
             c.request_id for c in partials}
    done2 = drain_all(srv2)
    final = {rid: done[rid] for rid in ids}
    for nid, rid in remap.items():
        final[rid] = done2[nid]
    assert [final[i].tokens for i in ids] == ref["rows"]
    assert all(final[i].finish_reason in ("eos", "length") for i in ids)
    srv2.check_alloc()
    srv2.close()


def test_drain_returns_partials_and_loop_books_drain_exits(ref):
    metrics.set_enabled(True)
    reg = metrics.get_registry()
    reg.reset()
    try:
        srv = GenerationServer(ref["model"], cfg(), num_slots=1,
                               device_loop_ticks=4)
        a = srv.submit(PROMPTS[0])
        b = srv.submit(PROMPTS[1])
        srv.step()
        srv.step()
        out = {c.request_id: c for c in srv.drain(max_ticks=1)}
        assert out[a].finish_reason == "preempted"
        assert out[a].tokens == ref["rows"][0][:len(out[a].tokens)]
        assert len(out[a].tokens) >= 2
        assert out[b].finish_reason == "preempted" and out[b].tokens == []
        # the drain's round trip ran one tick, booked as a drain exit
        assert reg.counter("serving/loop_exit/drain") == 1
        with pytest.raises(RequestShed, match="draining"):
            srv.submit(PROMPTS[2])
        assert srv.health_snapshot()["status"] == "draining"
        srv.close()
    finally:
        reg.reset()
        metrics.set_enabled(False)


def test_sigterm_flips_drain_mode_and_close_restores(ref):
    prev = signal.getsignal(signal.SIGTERM)
    srv = GenerationServer(ref["model"], cfg(), num_slots=1,
                           drain_on_sigterm=True)
    try:
        ids = [srv.submit(p) for p in PROMPTS[:3]]
        srv.step()
        os.kill(os.getpid(), signal.SIGTERM)
        assert srv.draining
        done = {c.request_id: c for c in srv.drain(max_ticks=0)}
        assert set(done) == set(ids)
        assert all(c.finish_reason == "preempted" for c in done.values())
    finally:
        srv.close()
    assert signal.getsignal(signal.SIGTERM) is prev
    srv.close()                                 # idempotent
    assert srv.step() == []                     # closed


def test_preempt_request_id(ref):
    srv = GenerationServer(ref["model"], cfg(), num_slots=1, **PAGED)
    a = srv.submit(PROMPTS[0])
    b = srv.submit(PROMPTS[1])
    srv.step()
    srv.step()
    cb = srv.preempt(b)                         # still queued
    assert cb.finish_reason == "preempted" and cb.tokens == []
    ca = srv.preempt(a)                         # running
    assert ca.finish_reason == "preempted"
    assert ca.tokens == ref["rows"][0][:len(ca.tokens)] and ca.tokens
    assert srv.preempt(a) is None and srv.preempt(99) is None
    assert srv.occupancy == 0 and srv.pending == 0
    s = srv.summary()
    assert s["preempted"] == 2 and s["pages_in_use"] == 0
    srv.check_alloc()
    srv.close()


def _preemption_run(make, events):
    """Two requests on a 5-page pool whose decode growth preempts one:
    completions in submission order."""
    rng = np.random.default_rng(5)
    pa = rng.integers(0, EOS, 250).tolist()
    pb = rng.integers(0, EOS, 124).tolist()
    srv = make(str(events))
    ids = [srv.submit(pa), srv.submit(pb)]
    done = drain_all(srv)
    srv.summary()
    srv.close()
    return [done[i] for i in ids]


def test_preemption_timeline_events_match_jax(ref, tmp_path):
    """The same preemption scenario through both servers: the same
    completions, the same non-span event names in the same order, and
    per trace the same span timeline (one root, queue -> prefill ->
    decode -> queue -> ... children, one first-token point)."""
    kw = dict(num_slots=2, page_size=128, pool_pages=5,
              prefill_chunk_pages=1)
    port = _preemption_run(lambda p: GenerationServer(
        ref["model"], cfg(max_dec=10), events_path=p, **kw),
        tmp_path / "port.jsonl")
    jax_ = _preemption_run(lambda p: JaxServer(
        ref["jmodel"], ref["params"], cfg(jax_gen.GenerationConfig, 10),
        events_path=p, **kw), tmp_path / "jax.jsonl")
    assert [c.tokens for c in port] == [c.tokens for c in jax_]
    evs = {"port": read_events(str(tmp_path / "port.jsonl")),
           "jax": jax_read_events(str(tmp_path / "jax.jsonl"))}
    names = {k: [e["event"] for e in v if not e["event"].startswith("span")]
             for k, v in evs.items()}
    assert names["port"] == names["jax"]
    assert "serving_preempt" in names["port"]

    def timeline(records, trace):
        return [(e["event"], e["name"], e.get("requeued"))
                for e in records if e.get("trace") == trace
                and e["event"].startswith("span")]

    for cp, cj in zip(port, jax_):
        tp = timeline(evs["port"], cp.trace_id)
        assert tp == timeline(evs["jax"], cj.trace_id)
        assert [n for ev, n, _ in tp if ev == "span_point"] == \
            ["serving/first_token"]
    mine = [e for e in evs["port"] if e["event"].startswith("span")]
    assert [e["ts"] for e in evs["port"]] == \
        sorted(e["ts"] for e in evs["port"])
    begun = sorted(e["span"] for e in mine if e["event"] == "span_begin")
    assert begun == sorted(e["span"] for e in mine
                           if e["event"] == "span_end")


def test_resume_links_trace_across_restart(ref, tmp_path):
    events = str(tmp_path / "events.jsonl")
    srv = GenerationServer(ref["model"], cfg(), num_slots=2,
                           events_path=events, **PAGED)
    [srv.submit(p) for p in PROMPTS]
    done = {}
    for _ in range(3):
        for c in srv.step():
            done[c.request_id] = c
    for c in srv.drain(max_ticks=0):
        done[c.request_id] = c
    srv.close()
    partials = [c for c in done.values() if c.finish_reason == "preempted"]
    assert partials and all(c.trace_id for c in partials)
    srv2 = GenerationServer(ref["model"], cfg(), num_slots=2,
                            events_path=events, **PAGED)
    remap = {srv2.submit(c.prompt, resume_tokens=c.tokens,
                         trace_id=c.trace_id): c for c in partials}
    done2 = drain_all(srv2)
    srv2.close()
    evs = read_events(events)
    for nid, c in remap.items():
        assert done2[nid].trace_id == c.trace_id
        roots = [e for e in evs if e["event"] == "span_begin"
                 and e["name"] == "serving/request"
                 and e["trace"] == c.trace_id]
        assert len(roots) == 2 and roots[0]["span"] != roots[1]["span"]
        if c.tokens:
            assert roots[1]["resumed"] is True
        ends = [e for e in evs if e["event"] == "span_end"
                and e["name"] == "serving/request"
                and e["trace"] == c.trace_id]
        assert len(ends) == 2
        assert ends[1]["tokens"] == len(done2[nid].tokens)


def _conv(seed=13, users=2, turns=2, sys_len=130):
    rng = np.random.default_rng(seed)
    system = rng.integers(0, EOS, sys_len).tolist()
    hist = [list(system) for _ in range(users)]
    waves = []
    for _ in range(turns):
        wave = []
        for u in range(users):
            hist[u] = hist[u] + rng.integers(0, EOS, 12 + 7 * u).tolist()
            wave.append(list(hist[u]))
        waves.append(wave)
    return waves


TIERED = dict(num_slots=2, seed=5, page_size=128, pool_pages=5,
              prefill_chunk_pages=1, host_pool_bytes=1 << 20)


def test_prefix_store_roundtrip_and_refusals(ref, tmp_path):
    """export -> save (manifest committed last) -> load -> import into a
    FRESH server: the adopter serves the same trace with rehydrates in
    place of prefill chunks, token-identically; a flipped byte is
    refused on load, and a model with other weights refuses the
    store."""
    model, g = ref["model"], cfg(max_dec=4)
    waves = _conv()
    with closing(GenerationServer(model, g, **TIERED)) as srv1:
        cold = [[c.tokens for c in srv1.run(w)] for w in waves]
        store = srv1.export_prefix_store()
        s1 = srv1.summary()
    assert store and store["pages"] and store["page_size"] == 128
    assert store["model_fingerprint"]
    path = str(tmp_path / "store")
    save_prefix_store(path, store)
    loaded = load_prefix_store(path)
    assert loaded["model_fingerprint"] == store["model_fingerprint"]
    with closing(GenerationServer(model, g, **TIERED)) as srv2:
        assert srv2.import_prefix_store(loaded) > 0
        warm = [[c.tokens for c in srv2.run(w)] for w in waves]
        s2 = srv2.summary()
        srv2.check_alloc()
    assert warm == cold
    assert s2["rehydrates"] > 0
    assert s2["prefill_chunks"] < s1["prefill_chunks"]
    # other weights, same geometry: refused
    other = build_model(model.config, model.word_embeddings.device,
                        seed=42)
    with closing(GenerationServer(other, g, **TIERED)) as srv3:
        assert srv3.import_prefix_store(loaded) == 0
        assert srv3._alloc.host_pages_resident == 0
    # a flipped byte in the page rows fails verification closed
    npz = os.path.join(path, "host_pages.npz")
    with open(npz, "r+b") as f:
        f.seek(os.path.getsize(npz) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    assert load_prefix_store(path) is None
    # a torn save (no manifest) too
    os.remove(os.path.join(path, "pfx_manifest.json"))
    assert load_prefix_store(path) is None


#: one Prometheus 0.0.4 sample line (# TYPE comments aside)
_SAMPLE = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*(\{le="[^"]+"\})? '
                     r'[-+0-9.einfE]+$')


def test_metrics_endpoint_scrape_flips_to_503_on_drain(ref, tmp_path):
    def get(path):
        try:
            with urllib.request.urlopen(msrv.url(path), timeout=10) as r:
                return r.status, r.read().decode("utf-8")
        except urllib.error.HTTPError as err:
            return err.code, err.read().decode("utf-8")

    obs_server.stop()
    srv = None
    try:
        srv = GenerationServer(ref["model"], cfg(max_dec=6), num_slots=2,
                               page_size=128, pool_pages=8,
                               prefill_chunk_pages=1,
                               events_path=str(tmp_path / "ev.jsonl"),
                               metrics_port=0)
        msrv = obs_server.get_server()
        assert msrv is not None and msrv.port > 0
        assert msrv.url("/x").startswith("http://127.0.0.1:")
        ids = [srv.submit([3, 1, 4, 1, 5]), srv.submit([2, 7, 1, 8, 2, 8])]
        done = {}
        for _ in range(4):
            for c in srv.step():
                done[c.request_id] = c
        code, body = get("/metrics")
        assert code == 200
        for line in body.splitlines():
            assert line.startswith("# TYPE ") or _SAMPLE.match(line), line
        assert "pfx_serving_ttft_ms_bucket" in body and 'le="+Inf"' in body
        code, body = get("/healthz")
        health = json.loads(body)
        assert code == 200 and health["status"] == "ok"
        assert health["slots"] == 2
        drain_all(srv, done)
        assert set(done) == set(ids)
        srv.drain()                               # idle drain: the flip
        code, body = get("/healthz")
        assert code == 503 and json.loads(body)["status"] == "draining"
        code, body = get("/trace")
        names = {e.get("name") for e in json.loads(body)["traceEvents"]}
        assert code == 200 and {"serving/request", "serving/queue"} <= names
        code, body = get("/vars")
        assert code == 200 and "serving/ttft_ms" in \
            json.loads(body)["histograms"]
        assert get("/timeline")[0] == 200 and get("/nope")[0] == 404
    finally:
        if srv is not None:
            srv.close()
        obs_server.stop()
    assert obs_server.get_server() is None
