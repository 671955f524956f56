"""tools/stage_time.py's trace reduction: device busy time as the union
of device intervals inside each host span, kernel and device-to-host
copy counts, and per-label medians -- on hand-made events and on a
trace recorded here."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "stage_time_t", os.path.join(ROOT, "tools", "stage_time.py"))
st = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(st)

# name: (span, events, (busy ns, kernels, d2h copies))
BUSY_CASES = {
    "disjoint": ((0, 100), [("k1", 10, 20), ("k2", 50, 10)], (30, 2, 0)),
    "overlapping_union": ((0, 100), [("k1", 10, 30), ("k2", 20, 30)],
                          (40, 2, 0)),
    "outside_span_ignored": ((100, 200), [("k1", 10, 30), ("k2", 150, 10),
                                          ("k3", 200, 5)], (10, 1, 0)),
    "clipped_at_span_end": ((0, 100), [("k1", 90, 50)], (10, 1, 0)),
    "copies_counted": ((0, 100), [("MemcpyD2H", 0, 5), ("MemcpyD2D", 10, 5),
                                  ("k", 20, 5)], (15, 1, 1)),
}


@pytest.mark.parametrize("case", list(BUSY_CASES))
def test_busy_in_span(case):
    (start, end), events, want = BUSY_CASES[case]
    assert st.busy_in_span(start, end, events) == want


def test_reduce_spans_takes_medians_per_label():
    spans = [("mfi_flow#1", 0, 1_000_000), ("mfi_flow#2", 2_000_000,
                                             4_000_000),
             ("mfi_flow#3", 5_000_000, 6_000_000),
             ("mfi_warp#1", 7_000_000, 8_000_000)]
    events = [("k", 0, 500_000), ("k", 2_000_000, 500_000),
              ("MemcpyD2H", 2_600_000, 100_000),
              ("k", 5_000_000, 250_000)]
    out = st.reduce_spans(spans, events)
    assert out["mfi_flow"]["calls"] == 3
    assert out["mfi_flow"]["wall_ms"] == 1.0
    assert out["mfi_flow"]["device_ms"] == 0.5
    assert out["mfi_flow"]["d2h"] == 0
    assert out["mfi_warp"]["device_ms"] == 0.0
    assert out["mfi_warp"]["idle_share"] == 1.0


def test_read_trace_finds_annotated_spans(tmp_path):
    """A trace recorded on this backend: every annotated call shows up
    as a host span; the CPU backend has no device plane."""
    import jax
    import jax.numpy as jnp
    f = jax.jit(lambda x: (x * 2).sum())
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    jax.profiler.start_trace(str(tmp_path))
    for i in range(3):
        with jax.profiler.TraceAnnotation(f"mfi_probe#{i}"):
            f(x).block_until_ready()
    jax.profiler.stop_trace()
    spans, events, dev = st.read_trace(str(tmp_path), "mfi_")
    assert sorted(s[0] for s in spans) == [f"mfi_probe#{i}"
                                           for i in range(3)]
    assert all(e > s for _, s, e in spans)
    out = st.reduce_spans(spans, events)
    assert out["mfi_probe"]["calls"] == 3
