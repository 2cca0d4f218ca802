"""The trace's reduction: each device operation goes to the ``pb.`` call
that launched it, and the roofline and MFU readers count each call's work
by the share of its device time inside the slice, so that work and time
cover the same stretch."""

import pytest

from perfbench.lib import flops, readers, trace


def _events():
    """A slice [100, 200) us.  Call 0 (``pb.unet``, 2 rows) runs on the
    device 90-110, half inside; call 1 (4 rows) 150-170, inside; call 2 (2
    rows) 190-230, a quarter inside; a copy launched outside any call
    runs 120-130."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.SLICE_SPAN, "tid": 9,
           "ts": 100.0, "dur": 100.0}]
    calls = [(50.0, "pb.unet#2", 90.0, 20.0), (120.0, "pb.unet#4", 150.0, 20.0),
             (180.0, "pb.unet#2", 190.0, 40.0)]
    for corr, (ts, name, dev_ts, dev_dur) in enumerate(calls):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "tid": 1, "ts": ts,
                   "dur": 8.0})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1,
                   "ts": ts + 1.0, "dur": 1.0, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": "flash_fwd_mma_a_kernel<48>",
                   "ts": dev_ts, "dur": dev_dur, "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "tid": 1,
               "ts": 110.0, "dur": 1.0, "args": {"correlation": 99}})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 120.0, "dur": 10.0,
               "args": {"correlation": 99}})
    return ev


def test_operations_go_to_their_call():
    tr = trace.reduce_trace(_events())
    assert tr["calls"] == [{"span": "pb.unet", "rows": 2}, {"span": "pb.unet", "rows": 4},
                           {"span": "pb.unet", "rows": 2}]
    assert [o["call"] for o in tr["ops"]] == [0, None, 1, 2]
    assert tr["busy_s"] == pytest.approx((10 + 10 + 20 + 10) / 1e6)
    assert trace.call_shares(tr) == {0: pytest.approx(0.5), 1: pytest.approx(1.0),
                                     2: pytest.approx(0.25)}


def _work(span, rows):
    c = flops.Count()
    c.attention(rows, 8, 4096, 4096, 40)
    c.flops += 1e12 * rows
    return c


def test_roofline_and_mfu_count_work_by_device_time():
    rec = {"trace": trace.reduce_trace(_events()), "work": _work,
           "stats_before": {"batched_rows": 0, "padded_rows": 0},
           "stats_after": {"batched_rows": 8, "padded_rows": 0}}
    bound = {rows: flops.attention_bound_s((rows, 8, 4096, 4096, 40))[0] for rows in (2, 4)}
    least = 0.5 * bound[2] + bound[4] + 0.25 * bound[2]
    assert readers.roofline_pct(rec, ("flash_fwd",), ("pb.unet",)) == pytest.approx(
        100 * least / 40e-6)
    work = 0.5 * _work("pb.unet", 2).flops + _work("pb.unet", 4).flops \
        + 0.25 * _work("pb.unet", 2).flops
    assert readers.mfu_pct(rec, ("pb.unet",)) == pytest.approx(
        100 * work / (flops.BF16_PEAK_FLOPS * 50e-6))
    # kernels of spans not listed count neither work nor time
    assert readers.roofline_pct(rec, ("flash_fwd",), ("pb.vae_decode",)) is None
