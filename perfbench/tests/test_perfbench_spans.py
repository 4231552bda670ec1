"""The readers of the program's spans (bench/spans.py) on fabricated
timelines: launches on another thread inside the main thread's span,
idle gaps split by overlap, syncs counted only inside their span, and what
a span without launches and a trace without spans read."""

import pytest

from perfbench.bench import spans, trace

MAIN, AUTOGRAD = 1, 2


def span(name, ts, dur, tid=MAIN):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def runtime(name, ts, tid=MAIN, dur=1):
    return {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def kernel(ts, dur):
    return {"cat": "kernel", "name": "elementwise_kernel", "ts": ts,
            "dur": dur, "tid": 7}


def window(ts, dur):
    return {"cat": "user_annotation", "name": trace.WINDOW_MARK, "ts": ts,
            "dur": dur, "tid": MAIN}


def pair_trace():
    """One DG pair over [0, 100): forward [10, 40), backward [40, 70),
    update [70, 90); the device idle over [0, 30) and [50, 75)."""
    return [window(0, 100),
            span("dgod.pair", 5, 90),
            span("dgod.half.m0", 5, 90),
            span("dgod.forward", 10, 30),
            span("dgod.backward", 40, 30),
            span("dgod.update", 70, 20),
            # another thread's span of the same name is not the program's
            span("dgod.update", 0, 100, tid=AUTOGRAD),
            kernel(30, 20), kernel(75, 25),
            runtime("cudaLaunchKernel", 12),
            runtime("cudaLaunchKernel", 20),
            # backward's launches come from autograd's device thread
            runtime("cudaLaunchKernel", 41, tid=AUTOGRAD),
            runtime("cuLaunchKernelEx", 60, tid=AUTOGRAD),
            runtime("cudaLaunchKernelExC", 71),
            runtime("cudaMemcpyAsync", 72),
            runtime("cudaStreamSynchronize", 38),
            runtime("cudaMemcpy", 80),
            # outside every span
            runtime("cudaLaunchKernel", 97),
            runtime("cudaDeviceSynchronize", 98)]


def test_perfbench_spans_launches_of_another_thread():
    r = spans.SpanReading(pair_trace(), units=1)
    assert r.launches("dgod.backward") == 2
    assert r.launches("dgod.forward") == 2
    assert r.launches("dgod.update") == 1
    assert r.launches("dgod.pair") == 5
    assert spans.SpanReading(pair_trace(), units=2).launches(
        "dgod.pair") == 2.5


def test_perfbench_spans_gap_split_by_overlap():
    r = spans.SpanReading(pair_trace(), units=1)
    # the gap [50, 75) straddles backward and update: 20 us and 5 us, not
    # all of it to backward, where its midpoint lies
    assert r.idle_ms("dgod.backward") == pytest.approx(20e-3)
    assert r.idle_ms("dgod.update") == pytest.approx(5e-3)
    # [0, 30) overlaps forward [10, 40) on 20 us
    assert r.idle_ms("dgod.forward") == pytest.approx(20e-3)
    assert r.idle_ms("dgod.pair") == pytest.approx((25 + 25) * 1e-3)


def test_perfbench_spans_syncs_inside_their_span():
    r = spans.SpanReading(pair_trace(), units=1)
    assert r.syncs("dgod.forward") == 1
    assert r.syncs("dgod.update") == 1
    assert r.syncs("dgod.backward") == 0
    assert r.syncs("dgod.pair") == 2


def test_perfbench_spans_empty_and_absent():
    events = pair_trace() + [span("dgod.targets", 6, 3)]
    r = spans.SpanReading(events, units=1)
    assert r.launches("dgod.targets") == 0
    assert r.syncs("dgod.targets") == 0
    assert r.idle_ms("dgod.targets") == pytest.approx(3e-3)
    assert r.launches("dgod.predict") is None
    # a program without spans: every reader reads None
    bare = [e for e in pair_trace() if not e["name"].startswith("dgod.")]
    r = spans.SpanReading(bare, units=1)
    for name in ("dgod.pair", "dgod.update", "dgod.predict"):
        assert r.launches(name) is None and r.syncs(name) is None
        assert r.idle_ms(name) is None
