"""The trace's reduction to busy time, kernel seconds and idle gaps, on a
made-up Chrome trace, and the per-layer readers on it."""

import pytest

from benchmarks import run, spec, trace, work


def _events():
    x = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name,  # noqa: E731
                                    "ts": ts, "dur": dur}
    return [x("user_annotation", "bench.window", 1000, 1000),
            x("user_annotation", "bench.request", 1000, 600),
            x("user_annotation", "bench.request", 1600, 400),
            x("kernel", "void attention_fwd_kernel<64>(bf16 const*)", 1100, 200),
            x("kernel", "nvjet_tst_192x192_bias_TNN", 1250, 100),   # overlaps
            x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1500, 50),
            x("kernel", "void int8_res_kernel<3>(CUtensorMap)", 1700, 200),
            x("kernel", "late", 1950, 100),                          # cut at 2000
            x("kernel", "early", 900, 50),                           # outside
            x("cpu_op", "aten::mm", 1100, 10)]


def test_busy_and_window():
    s = trace.Summary.from_events(_events())
    assert s.window_s == pytest.approx(1000e-6)
    # 1100-1350, 1500-1550, 1700-1900, 1950-2000
    assert s.busy_s == pytest.approx(550e-6)


def test_kernel_seconds_by_pattern():
    s = trace.Summary.from_events(_events())
    assert s.seconds(r"attention_fwd_kernel") == pytest.approx(200e-6)
    assert s.seconds(r"int8_wgmma_kernel|int8_res_kernel") == pytest.approx(200e-6)
    assert s.seconds(r"nothing") == 0


def test_device_ops_and_idle_gaps():
    s = trace.Summary.from_events(_events())
    ops = dict(s.device_ops())
    assert ops["attention_fwd_kernel"] == pytest.approx(200e-6)
    assert ops["int8_res_kernel"] == pytest.approx(200e-6)
    gaps = dict(s.idle_gaps())
    # 1000-1100, 1350-1500, 1550-1600 in the first request; 1600-1700,
    # 1900-1950 in the second
    assert gaps["request"] == pytest.approx(450e-6)
    assert sum(gaps.values()) == pytest.approx(s.window_s - s.busy_s)


def test_trace_without_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.Summary.from_events(_events()[1:])


def test_readers_on_the_trace():
    s = trace.Summary.from_events(_events())
    cell = spec.load("vit_b16.serve_bf16")
    out = run.per_layer(cell, type("O", (), {"items": 8, "window_s": 0.5,
                                             "trace": s, "traced_items": 2})())
    assert out["device_idle_pct.serve"]["value"] == pytest.approx(45.0)
    ops, nbytes = work.attention_forward(2, cell.model)
    assert out["attn_roofline_pct.serve"]["value"] == pytest.approx(
        100 * max(ops / 989e12, nbytes / 3.35e12) / 200e-6)
    assert out["mfu_pct.serve"]["value"] == pytest.approx(
        100 * 2 * 8 * sum(cell.reference().work(cell.model).values())
        / 0.5 / 989e12)


def test_readers_find_nothing_without_a_trace():
    cell = spec.load("vit_b16.serve_int8")
    out = run.per_layer(cell, type("O", (), {"items": 8, "window_s": 1.0,
                                             "trace": None, "traced_items": 0})())
    assert set(out) == {"mfu_pct.serve"}
