"""The reduction of a trace to records: the busy union, device time by
operation, and idle gaps named by what the host was doing."""

import pytest

from portbench import trace

CUDA, CPU = "cuda", "cpu"


class Ev:
    """The part of a kineto event that the reduction reads."""

    def __init__(self, name, dev, s, e):
        self._v = (name, dev, s, e)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]


def events():
    return [
        Ev(trace.WINDOW_SPAN, CPU, 0, 1000),
        Ev(trace.JOB_SPAN, CPU, 0, 1000),
        Ev(trace.JOB_SPAN, CUDA, 0, 1000),
        # a sort that launches, a sync inside an item(), and a copy that
        # overlaps the item without nesting in it (another thread)
        Ev("aten::sort", CPU, 100, 300),
        Ev("cudaLaunchKernel", CPU, 150, 160),
        Ev("aten::item", CPU, 380, 1000),
        Ev("cudaMemcpyAsync", CPU, 390, 995),
        Ev("aten::copy_", CPU, 300, 440),
        # the device
        Ev("Memcpy HtoD (Pageable -> Device)", CUDA, 450, 500),
        Ev("void merge_tile_kernel<1>(ColSet)", CUDA, 200, 260),
        Ev("void at::native::sort_kernel", CUDA, 240, 300),
        Ev("Memset (Device)", CUDA, 1100, 1200),
    ]


def test_reduce_trace_busy_ops_and_gaps():
    rec = trace.reduce_trace(events(), CUDA)
    assert rec["window_s"] == pytest.approx(1000e-9)
    # [200, 300) and [450, 500); the memset is after the window
    assert rec["busy_s"] == pytest.approx(150e-9)
    assert rec["device_ops"] == pytest.approx({
        "Memcpy HtoD (Pageable -> Device)": 50e-9,
        "void merge_tile_kernel<1>(ColSet)": 60e-9,
        "void at::native::sort_kernel": 60e-9})
    gaps = rec["idle_gaps"]
    # [0, 200): the sort covers 100-200, nothing 0-100
    # [300, 450): the copy overlaps most (140); the copy and the item
    # cover 300-450 together
    # [500, 1000): the item, and the memcpy inside it, which is innermost
    # but overlaps less (495): the item (500) takes it
    assert gaps == pytest.approx({
        "aten::sort": 100e-9, trace._NO_OP: 100e-9, "aten::copy_": 150e-9,
        "aten::item": 500e-9})


def test_a_gap_with_no_torch_op_is_the_hosts_own_work():
    evs = [Ev(trace.WINDOW_SPAN, CPU, 0, 100),
           Ev("k", CUDA, 10, 20)]
    gaps = trace.reduce_trace(evs, CUDA)["idle_gaps"]
    assert gaps == pytest.approx(
        {"no torch op (host parse, pack or Python)": 90e-9})


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce_trace([Ev("k", CUDA, 0, 1)], CUDA)


def test_busy_union_merges_overlaps():
    assert trace.busy_union_ns([(0, 10), (5, 15), (20, 30), (30, 31)]) == 26
    assert trace.busy_union_ns([]) == 0


def test_top_keeps_the_ten_largest():
    d = {f"op{i}": float(i) for i in range(15)}
    out = trace.top(d)
    assert len(out) == 10 and out[0] == ["op14", 14.0]


def test_port_kernels_and_copies_by_name():
    assert trace.is_port_kernel("void compact_kernel<2, true>(int)")
    assert trace.is_port_kernel("lane_mix_kernel")
    assert not trace.is_port_kernel("void cub::DeviceRadixSortKernel")
    assert not trace.is_port_kernel("my_compact_kernel_x")
    assert trace.is_copy("Memcpy DtoH (Device -> Pinned)")
