"""``chip_smoke.py``'s ``serve_loop`` arms on the CPU at a tiny size:
each serving path again at ``LOOP_TICKS`` ticks a round trip, held
token for token to its T = 1 phase, with the launch counts exact over
the launched ticks (counting shims stand in for the kernels' counts).
On the CPU the servers' tick graph runs its tick eagerly, one call a
launched tick, so the arms run with no warm-up tick; the profiler, which
reads the card's trace, is stubbed with one that reports the counted
launches as traced. The reading of real kernel names from a trace, and
the check that holds them to the counts, are tested on their own."""

import copy

import pytest

from _chip_smoke_shims import TINY, _lines, chip_smoke, fa, shims  # noqa: F401
from test_torch_chip_smoke import TINY_HEADLINE
from test_torch_chip_smoke_moe import SERVE_TINY

LOOP = 4


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(chip_smoke, "HEADLINE", TINY_HEADLINE)
    monkeypatch.setattr(chip_smoke, "LOOP_TICKS", LOOP)


T1_WINDOW = {"window": "decode_paged", "wall_ms": 40.0,
             "device_busy_ms": 4.0, "idle_share": 0.9,
             "kernels_per_step": 500.0, "steps": 16}


@pytest.fixture
def traced(monkeypatch):
    """``profile_window`` runs its window and reports the launches the
    wrappers counted in it as the trace's."""
    def window(torch, label, fn, steps, runtime=False):
        fn()
        return dict(T1_WINDOW, window=label,
                    traced_launches=chip_smoke.counted_launches(
                        chip_smoke.read_counts()))
    monkeypatch.setattr(chip_smoke, "profile_window", window)


def _arms(capsys):
    return {d["arm"]: d for d in _lines(capsys)
            if d.get("phase") == "serve_loop" and "arm" in d}


def _held(arm, kernel, layers=2):
    assert arm["rows_equal_t1"] and arm["loop_ticks"] == LOOP
    assert arm["host_roundtrips"] < arm["device_ticks"]
    assert arm["device_ticks"] == arm["t1"]["decode_ticks"]
    assert arm["launches"][kernel] == arm["ticks_replayed"] * layers > 0
    assert sum(arm["loop_exit"].values()) == arm["host_roundtrips"]


def test_contiguous_and_dense_paged_arms(shims, tiny, traced, capsys):
    serve, module = chip_smoke.phase_serve("cpu", TINY, requests=5, slots=3,
                                           lo=5, hi=60)
    chip_smoke.phase_serve_loop_contiguous(module, serve, "cpu")
    paged, module = chip_smoke.phase_serve_paged("cpu", TINY)
    windows = [T1_WINDOW, dict(T1_WINDOW, window="verify_paged")]
    arms = chip_smoke.phase_serve_loop_paged(module, paged, windows, "cpu")
    lines = _arms(capsys)
    _held(lines["serve_loop_contiguous"], "flash_decode")
    assert lines["serve_loop_contiguous"]["traced_launches"][
        "decode_contiguous_plain"] > 0
    _held(lines["serve_loop_paged"], "flash_decode_paged")
    _held(lines["serve_loop_spec"], "flash_decode_paged_verify")
    # the tiny pool cannot hold LOOP ticks of growth: one tick a trip
    for name in ("profile", "profile_spec"):
        assert arms[name]["graph_replays"] == arms[name]["ticks_run"] >= 1
    assert arms["profile_spec"]["traced_launches"]["decode_paged_plain"] == \
        arms["profile_spec"]["graph_replays"] * 2


def test_int8_moe_and_lora_arms(shims, tiny, traced, capsys):
    runs, module = chip_smoke.phase_serve_int8(
        {}, "cpu", TINY, short={"requests": 2, "max_dec_len": 4})
    chip_smoke.phase_serve_loop_int8(module, runs, "cpu",
                                     short={"requests": 2, "max_dec_len": 4})
    moe, module = chip_smoke.phase_serve_moe("cpu", SERVE_TINY, requests=4)
    chip_smoke.serve_loop_arm(module, "serve_loop_moe", moe["paged"], "cpu",
                              requests=4)
    moe_profile = chip_smoke.profile_loop(
        module, T1_WINDOW, "cpu", "decode_paged_moe_loop")
    record, module = chip_smoke.phase_serve_lora("cpu", TINY)
    mixed = (chip_smoke.lora_source(module.model, module.seed), [1, 2, 3, 4])
    chip_smoke.serve_loop_arm(module, "serve_loop_lora",
                              record["arms"]["mixed"], "cpu", adapters=mixed)
    lora_profile = chip_smoke.profile_loop(
        module, T1_WINDOW, "cpu", "decode_paged_lora_loop", adapters=mixed)
    lines = _arms(capsys)
    assert lines["serve_loop_int8_spec"]["traced_launches"][
        "decode_paged_int8"] > 0
    for window in (moe_profile, lora_profile):
        assert window["traced_launches"]["grouped_matmul"] > 0
    _held(lines["serve_loop_int8"], "flash_decode_paged_int8")
    _held(lines["serve_loop_int8_spec"], "flash_decode_paged_verify_int8")
    assert lines["serve_loop_int8_spec"]["launches_by_route"][
        "quantized_matmul"]["wgmma"] > 0
    _held(lines["serve_loop_moe"], "flash_decode_paged")
    _held(lines["serve_loop_lora"], "flash_decode_paged")
    assert lines["serve_loop_moe"]["launches"]["grouped_matmul"] == \
        2 * 2 * (lines["serve_loop_moe"]["ticks_replayed"] +
                 moe["paged"]["prefill_chunks"]) > 0


def test_loop_check_catches_a_differing_row(shims, tiny):
    """A row that differs from the T = 1 run where the model is not at a
    near-tie fails the arm."""
    paged, module = chip_smoke.phase_serve_paged("cpu", TINY)
    wrong = copy.deepcopy(paged)
    row = wrong["tokens"][0]
    row[1] = (row[1] + 1) % module.model_config.vocab_size
    with pytest.raises(AssertionError, match="near-tie"):
        chip_smoke.serve_loop_arm(module, "serve_loop_paged", wrong, "cpu")


#: demangled kernel names as the card's trace gives them
NAMES = {
    "void (anonymous namespace)::decode_kernel_mma<__nv_bfloat16, 64, "
    "true>((anonymous namespace)::Args, int, int)":
        ("decode_paged_plain", "decode_paged/mma"),
    "void (anonymous namespace)::decode_kernel_mma<signed char, 64, true>("
    "(anonymous namespace)::Args, int, int)":
        ("decode_paged_int8", "decode_paged/mma"),
    "void (anonymous namespace)::decode_kernel<float, float, 64, 1, false>("
    "(anonymous namespace)::Args)":
        ("decode_contiguous_plain", "decode_contiguous/simt"),
    "void (anonymous namespace)::qmm_wgmma_kernel<false>(CUtensorMap_st, "
    "CUtensorMap_st, CUtensorMap_st, float const*, __nv_bfloat16*, int)":
        ("quantized_matmul", "quantized_matmul/wgmma"),
    "void (anonymous namespace)::qmm_stream_kernel<true, 2>(CUtensorMap_st,"
    " int)": ("quantized_matmul_dx", "quantized_matmul_dx/stream"),
    "void (anonymous namespace)::gmm_split_kernel<1, 8, 0>(__nv_bfloat16 "
    "const*, __nv_bfloat16 const*, int const*, void*, int)":
        ("grouped_matmul", "grouped_matmul/split"),
    "void (anonymous namespace)::gmm_dw_split_kernel<1, 8>(__nv_bfloat16 "
    "const*, int)": ("grouped_matmul_dw", "grouped_matmul_dw/split"),
    "void (anonymous namespace)::flash_fwd_wgmma<64, 128, false, false>("
    "CUtensorMap_st, float*)": ("flash_attention", "flash_attention/wgmma"),
    "void (anonymous namespace)::flash_bwd_dq_wgmma<64>(CUtensorMap_st)":
        ("flash_bwd_dq",),
    "nvjet_tst_64x8_64x16_4x2_h_bz_bias_TNT": (),
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::FillFunctor<float>, std::array<char*, 1ul> >(int, "
    "at::native::FillFunctor<float>, std::array<char*, 1ul>)": (),
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_trace_keys_read_kernel_names(name):
    assert chip_smoke.trace_keys(name) == NAMES[name]


def test_traced_launches_must_equal_the_counts(shims):
    """One replayed tick's kernels missing from the trace, a route the
    counts do not hold, or a trace with no hand-written kernel fails."""
    chip_smoke.reset_counts()
    fa.flash_decode_paged.launches += 48
    fa.flash_decode_paged.launches_by_route["mma"] += 48
    counts = chip_smoke.read_counts()
    want = {"decode_paged_plain": 48, "decode_paged/mma": 48}
    assert chip_smoke.check_traced_launches("t", dict(want), counts) == want
    for traced in ({"decode_paged_plain": 24, "decode_paged/mma": 24},
                   dict(want, **{"decode_paged/simt": 1}), {}):
        with pytest.raises(AssertionError, match="device trace"):
            chip_smoke.check_traced_launches("t", traced, counts)
    chip_smoke.reset_counts()
    with pytest.raises(AssertionError, match="device trace"):
        chip_smoke.check_traced_launches("t", {}, chip_smoke.read_counts())
