"""The arithmetic of the metrics: flop formulas, the tail over every
call, the window's rate, and the device trace's busy union and idle
gaps on a synthetic trace."""

import math

import pytest

from benchmark import devtrace, flops, harness, spec, traffic

CELL = spec.cell("cacqr.m2e20")


def _readings(calls, **rank):
    r0 = dict(calls=calls, window_s=calls[-1][2], peak_window=3 * 2**30,
              peak_run=4 * 2**30, profiled=0, launches=None,
              link_bytes=None, trace=None, check_s=0.0, sample=0)
    r0.update(rank)
    return harness.Readings(CELL, 12.5, [r0])


def _flops(name, **dims):
    return flops.per_call({"flops": name}, dims)


def test_flop_formulas():
    assert _flops("cholinv", n=3) == 18.0
    assert _flops("cholinv", n=32768) == pytest.approx(2.345e13, rel=1e-3)
    # two sweeps of: Gram 2mn^2, Q 2mn^2, Cholesky + inverse 2n^3/3
    m, n = 10, 3
    assert _flops("cacqr2", m=m, n=n) == 2 * (2 * m * n * n + 2 * m * n * n
                                              + 2 * n**3 / 3)
    assert _flops("cacqr2", m=1 << 20, n=1024) == pytest.approx(8.796e12,
                                                                 rel=1e-3)
    # LU: the leading term 2n^3/3 of LAWN 41's 2n^3/3 - n^2/2 + 5n/6
    assert _flops("lu", n=3) == 18.0
    assert _flops("lu", n=32768) == pytest.approx(2.345e13, rel=1e-3)
    with pytest.raises(FileNotFoundError):
        _flops("no_such_formula", n=3)
    with pytest.raises(ValueError):
        _flops("../flops", n=3)


def test_each_cell_counts_the_flops_it_counted_before():
    # the floats of the formulas as they stood in one module, to the bit
    want = {"cholinv.n32768": 2.0 * 32768**3 / 3.0,
            "cacqr.m2e20": 2.0 * (4.0 * 2**20 * 1024 * 1024
                                  + 2.0 * 1024**3 / 3.0),
            "cacqr.m2e24.ranks4": 2.0 * (4.0 * 2**24 * 1024 * 1024
                                         + 2.0 * 1024**3 / 3.0)}
    for name, f in want.items():
        c = spec.cell(name)
        assert flops.per_call(c.config, traffic.shape(c.config, c.traffic)
                              ).hex() == f.hex(), name


def test_tail_is_taken_over_every_call():
    # 100 calls of 10 ms, then 11 slow ones: the p90 (nearest rank, the
    # 100th of 111) is a fast call; with 12 slow ones it is a slow call
    p90 = spec.reader("call_ms.p90")
    calls = [(i, i + 0.001, i + 0.010, False) for i in range(100)]
    slow = [(100 + i, 100 + i + 0.001, 100 + i + 0.5, True)
            for i in range(12)]
    assert p90(_readings(calls + slow[:11])) == pytest.approx(10.0)
    assert p90(_readings(calls + slow)) == pytest.approx(500.0)
    # order does not matter: the traced and the first calls count too
    assert p90(_readings(slow + calls)) == pytest.approx(500.0)


def test_rate_memory_setup_and_dispatch():
    calls = [(0.0, 0.01, 0.5, False), (0.5, 0.52, 1.0, True),
             (1.0, 1.03, 2.0, False)]
    r = _readings(calls)
    assert spec.reader("gflops")(r) == pytest.approx(
        3 * _flops("cacqr2", m=1 << 20, n=1024) / 2.0 / 1e9)
    assert spec.reader("peak_mem_gib")(r) == 3.0
    assert spec.reader("setup_s")(r) == 12.5
    # the dispatch span leaves out the traced call
    assert spec.reader("dispatch_ms")(r) == pytest.approx(20.0)


def test_readers_return_nothing_without_a_trace():
    r = _readings([(0.0, 0.01, 0.5, False)])
    for name in ("launches", "trmm_ms", "syrk_ms", "comm_ms", "link_mib",
                 "device_idle_pct"):
        assert spec.reader(name)(r) is None


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


EVENTS = [
    # two traced calls, 0-100 and 120-200 us
    _x("user_annotation", devtrace.CALL, 0, 100),
    _x("user_annotation", devtrace.CALL, 120, 80),
    _x("user_annotation", "CQR::gram", 0, 60),
    _x("cpu_op", "aten::empty", 40, 10),
    # device: overlapping kernels 10-30 and 20-40, a copy 60-70,
    # a kernel 150-190, a kernel of another call outside the window
    _x("kernel", "void syrk_ffma_kernel<1>(float const*)", 10, 20, tid=7),
    _x("kernel", "void syrk_ffma_kernel<1>(float const*)", 20, 20, tid=8),
    _x("gpu_memcpy", "Memcpy DtoD", 60, 10, tid=7),
    _x("kernel", "ncclDevKernel_AllReduce_Sum_f32(x)", 150, 40, tid=7),
    _x("kernel", "trmm_wgmma_kernel<2>", 300, 50, tid=7),
    _x("gpu_user_annotation", "CQR::gram", 0, 200, tid=7),
]


def test_device_busy_union_and_idle_gaps():
    t = devtrace.summarize(EVENTS)
    assert t["window_s"] == pytest.approx(200e-6)
    # busy 10-40, 60-70, 150-190: 80 us; the annotation is not work
    assert t["busy_s"] == pytest.approx(80e-6)
    assert t["device_s"] == pytest.approx({
        "syrk_ffma_kernel<1>": 40e-6, "Memcpy DtoD": 10e-6,
        "ncclDevKernel_AllReduce_Sum_f32": 40e-6})
    idle = t["idle_s"]
    assert math.fsum(idle.values()) == pytest.approx(120e-6)
    # 0-10 in the phase; 40-60 in the phase's aten::empty; 70-150 cut at
    # the calls' ends and starts: 70-100 and 120-150 in a call outside
    # any phase, 100-120 between the calls; 190-200 in the second call
    assert idle == pytest.approx({
        "CQR::gram": 10e-6, "CQR::gram / aten::empty": 20e-6,
        devtrace.CALL: 30e-6 + 30e-6 + 10e-6, devtrace.BETWEEN: 20e-6})
    assert devtrace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [
        ["b", 3.0], ["c", 2.0]]


def test_device_time_by_name_is_the_part_inside_the_window():
    # the device's clock lays the first kernel 5 us before the call's
    # host start and the last 10 us past its end: each counts for its
    # part inside, as the busy time takes it; the call's range on the
    # device's timeline does not bound the window
    t = devtrace.summarize([
        _x("user_annotation", devtrace.CALL, 0, 100),
        _x("gpu_user_annotation", devtrace.CALL, -20, 140, tid=7),
        _x("kernel", "syrk_ffma_kernel<1>", -5, 50, tid=7),
        _x("kernel", "trmm_ffma_kernel", 60, 50, tid=7)])
    assert t["device_s"] == pytest.approx({
        "syrk_ffma_kernel<1>": 45e-6, "trmm_ffma_kernel": 40e-6})
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx(math.fsum(t["device_s"].values()))


def test_kernel_readers_and_idle_share():
    t = devtrace.summarize(EVENTS)
    r = _readings([(0, 0, 1e-4, True), (1.2e-4, 1.2e-4, 2e-4, True)],
                  trace=t, profiled=2, launches=14, link_bytes=2**21)
    assert spec.reader("syrk_ms")(r) == pytest.approx(40e-3 / 2)
    assert spec.reader("comm_ms")(r) == pytest.approx(40e-3 / 2)
    assert spec.reader("trmm_ms")(r) is None  # ran outside the window
    assert spec.reader("launches")(r) == 7.0
    assert spec.reader("device_idle_pct")(r) == pytest.approx(60.0)
    assert spec.reader("link_mib")(r) is None  # one rank moves nothing
    r.ranks.append(dict(r.ranks[0], trace=dict(t, busy_s=180e-6)))
    assert spec.reader("link_mib")(r) == pytest.approx(1.0)
    assert spec.reader("device_idle_pct")(r) == pytest.approx(
        (60.0 + 10.0) / 2)


def test_operation_names_lose_their_arguments_and_return_type():
    short = devtrace._short
    assert short("void (anonymous namespace)::trmm_wgmma_kernel<2, 1>"
                 "(CUtensorMap, float*, int)") == \
        "(anonymous namespace)::trmm_wgmma_kernel<2, 1>"
    assert short("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    assert short("ncclDevKernel_AllReduce_Sum_f32_RING_LL"
                 "(ncclDevKernelArgsStorage<4096ul>)") == \
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL"
    assert short("aten::mm") == "aten::mm"
