"""The traced run's reader on fabricated timelines, and the window's
statistics over all of its work."""

import pytest

from perfbench.bench import common, trace


def kernel(name, ts, dur, stream=7):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "tid": stream}


def host(name, ts, dur, cat="cpu_op"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def mark(ts, dur):
    return {"cat": "user_annotation", "name": trace.WINDOW_MARK, "ts": ts,
            "dur": dur}


def test_perfbench_overlapping_streams_count_once():
    # two streams overlap on [20, 30); a stall with nothing on the device
    # from 60 to 90, while the host waits in aten::nonzero
    events = [mark(0, 100),
              kernel("sm90_xmma_fprop_gemm", 10, 20, stream=7),
              kernel("vectorized_elementwise_kernel", 20, 20, stream=8),
              kernel("elementwise_kernel", 40, 20),
              host("aten::nonzero", 55, 40),
              kernel("(anonymous namespace)::fwd_kernel<float>", 90, 5),
              kernel("outside the window", 150, 10)]
    p = trace.Profile(events, units=2)
    assert p.window_s == pytest.approx(100e-6)
    # union: [10, 60) and [90, 95): 55 us, not the 65 us of the sum
    assert p.busy_s == pytest.approx(55e-6)
    assert p.idle_share == pytest.approx(0.45)
    assert p.gaps() == [[0, 10], [60, 90], [95, 100]]
    cats = p.category_s()
    assert cats["conv / gemm (cuDNN, cuBLAS)"] == pytest.approx(20e-6)
    assert cats["elementwise / copy"] == pytest.approx(40e-6)
    assert cats["K1 roi_align_fwd (port)"] == pytest.approx(5e-6)
    b = p.breakdown(p)
    assert b["idle_gaps"][0] == ["aten::nonzero", pytest.approx(30e-6)]
    assert b["device_ops"][0][0] == "sm90_xmma_fprop_gemm"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_perfbench_window_from_synchronises():
    # a trace of the device and the CUDA runtime alone: the window runs
    # from the end of the first device synchronise to the end of the last
    events = [host("cudaDeviceSynchronize", 0, 5, cat="cuda_runtime"),
              host("cudaLaunchKernel", 6, 2, cat="cuda_runtime"),
              kernel("gemm", 10, 30),
              host("cudaDeviceSynchronize", 8, 42, cat="cuda_runtime")]
    p = trace.Profile(events, units=1)
    assert (p.lo, p.hi) == (5, 50)
    assert p.busy_s == pytest.approx(30e-6)
    assert p.host_op_at(45) == "cudaDeviceSynchronize"
    with pytest.raises(ValueError):
        trace.Profile([kernel("gemm", 0, 1)], units=1)


def test_perfbench_tail_over_all_requests():
    # 100 requests: 90 at 10 ms, a stall of 10 at 50 ms. A median of
    # chunk medians would hide the stall; the p95 of all requests shows it
    lat = [10.0] * 90 + [50.0] * 10
    assert common.percentile(lat, 95) == pytest.approx(50.0)
    assert common.median(lat) == 10.0
    chunks = [common.percentile(lat[i::10], 95) for i in range(10)]
    assert common.median(chunks) < 50.0


def test_perfbench_train_rate_over_whole_window():
    from perfbench.bench import train

    w = {"images": 1920, "seconds": 10.0}
    assert train.end_to_end(w) == {"train_images_per_s": 192.0}
