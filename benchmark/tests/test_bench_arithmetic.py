"""The metric arithmetic on fixed inputs."""
import math

import pytest

import harness
from frozen import kernel_work, trace_math
from reference import check, headers


def test_breakdown():
    got = harness.breakdown(dict(device=[("b", 10, 30), ("a", 0, 10),
                                         ("c", 40, 45)], wall_s=1))
    assert got["device_ops"] == [["b", 20e-6], ["a", 10e-6], ["c", 5e-6]]
    assert got["idle_gaps"] == [["b -> c", 10e-6]]


def test_busy_and_gaps():
    spans = [(0, 10), (5, 15), (20, 30), (28, 29), (40, 41)]
    assert trace_math.busy_us(spans) == 15 + 10 + 1
    assert trace_math.idle_gaps(spans, 0, 50) == [(30, 40), (41, 50),
                                                   (15, 20)]
    assert trace_math.top_by_time([("k", 0, 2), ("m", 0, 3), ("k", 5, 7)]) \
        == [("k", 4), ("m", 3)]


def test_pool_plays_forward_then_backward():
    assert [harness.pool_index(i, 4) for i in range(9)] == \
        [0, 1, 2, 3, 2, 1, 0, 1, 2]
    assert harness.pool_index(10 ** 6, 1) == 0


def test_kernel_work_counts():
    cfg = dict(padded_height=128, padded_width=128, num_ref_frames=1,
               rd_mode="RD_ULTRAFAST", intra_in_p=True)
    calls = kernel_work.main_path_calls(cfg)
    n = 64
    assert calls["gather_windows"][0] == (n, 20, (1, 64 + 156, 64 + 156),
                                          (8, 8, 8, 1))
    assert len(calls["gather_windows"]) == 3 + 1          # ME + one merge
    # a grid gather: output, two index vectors, the windows' zero-motion
    # union of the plane
    got = kernel_work.gather_bytes("gather_windows", (n, 22, (1, 416, 416),
                                                      (8, 8, 16, 1)))
    assert got == 4 * n * 22 * 22 + 4 * 2 * n + 4 * (7 * 16 + 22) ** 2
    # a gather at content-chosen sites counts no plane bytes
    assert kernel_work.gather_bytes("gather_windows_ref",
                                    (10, 7, (2, 100, 100), None)) \
        == 4 * 10 * 49 + 4 * 3 * 10
    nbytes, ops = kernel_work.slab_bytes_ops((16, 16, 2, 8, 16))
    assert nbytes == 4 * (256 + 32 * 48 + 64)
    assert ops == 3 * 17 * 33 * 256
    ms = kernel_work.least_ms(cfg)
    assert ms["slab_search"] == pytest.approx(sum(
        max(b / 3.35e12, o / 67e12) * 1e3 for b, o in
        map(kernel_work.slab_bytes_ops, calls["slab_search"])))


class _Run:
    frames = 8
    window_s = 2.0
    window_bits = 8 * 1000
    config = {"video": {"frame_rate": 60}}
    sse_y = 100 * 255 ** 2
    px_y = 10 ** 6
    setup_s = 3.5
    dispatch_s = 0.4
    stages = {"entropy": 0.08}
    spans = {"models.inter_frame": 0.24}
    cell = {"bench_dir": harness.BENCH_DIR}
    traced = dict(device=[("gather_windows_kernel(int)", 0, 10),
                          ("void slab_search_kernel(int)", 20, 30),
                          ("add", 25, 40)],
                  wall_s=100e-6, frames=2)


@pytest.mark.parametrize("name,value", [
    ("fps", 4.0), ("kbps", 60.0), ("psnr_y_db", 40.0), ("setup_s", 3.5),
    ("dispatch_ms_per_frame", 50.0), ("entropy_ms_per_frame", 10.0),
    ("device_ops_per_frame", 1.5), ("device_idle_share", 70.0),
    ("p_program_host_ms_per_frame", 30.0), ("fps.ai", 4.0),
    ("dispatch_ms_per_frame.ai", 50.0), ("entropy_ms_per_frame.ai", 10.0),
    ("device_ops_per_frame.ai", 1.5), ("device_idle_share.ai", 70.0)])
def test_readers(name, value):
    assert harness.metric_reader(name)(_Run()) == pytest.approx(value)


@pytest.mark.parametrize("metric,stem,wrappers", [
    ("gather_windows_roofline", "gather_windows",
     ("gather_windows", "gather_windows_ref")),
    ("slab_search_roofline", "slab_search", ("slab_search",))])
def test_kernel_roofline_readers(metric, stem, wrappers):
    run = _Run()
    run.config = {"video": {"width": 1280, "height": 720},
                  "encoder": {"rd_mode": "RD_FAST"}}
    least = harness.kernel_least_ms(run.config)
    per_frame_ms = 10e-3 / 2       # 10 us of the kernel over 2 frames
    assert harness.metric_reader(metric)(run) == \
        pytest.approx(100 * sum(least[k] for k in wrappers) / per_frame_ms)
    run.traced = dict(run.traced, device=[("add", 0, 1)])
    assert harness.metric_reader(metric)(run) is None


def test_psnr_reader_leaves_out_a_run_with_nothing_decoded():
    run = _Run()
    run.px_y = 0
    assert harness.metric_reader("psnr_y_db")(run) is None
    assert not math.isinf(harness.metric_reader("psnr_y_db")(_Run()))


def _guarantees(**kw):
    g = dict(width=64, height=32, bit_depth=8, slice_qp=32, sao=True,
             deblocking=True, sign_hiding=True, cu_qp_delta=False,
             scaling_lists=False, tile_grid=None, num_ref_idx_l0=1,
             idr_period=0)
    g.update(kw)
    return g


def _picture(**kw):
    sps = dict(width=64, height=32, chroma_format_idc=1, bit_depth_luma=8,
               bit_depth_chroma=8, sao=1, scaling_lists=False)
    pps = dict(sign_hiding=1, cu_qp_delta=0, tile_grid=None,
               transform_skip=0, transquant_bypass=0)
    p = dict(sps=sps, pps=pps, slice_qp=32, sao_luma=1, sao_chroma=1,
             deblocking_disabled=0, idr=False, slice_type=1,
             num_ref_idx_l0=1)
    p.update(kw)
    return p


def test_guarantee_breaks():
    g = _guarantees()
    assert check.picture_breaks(_picture(), 3, g) == []
    assert check.picture_breaks(_picture(slice_qp=33), 3, g) == \
        ["slice_qp 33 != 32"]
    assert check.picture_breaks(_picture(), 0, g) == \
        ["idr False != True", "slice_type 1 != 2"]
    assert check.picture_breaks(_picture(idr=True, slice_type=2), 0, g) == []
    assert check.picture_breaks(_picture(sao_chroma=0), 1, g)
    assert check.picture_breaks({"error": "x"}, 1, g) == ["x"]


def test_headers_bits():
    r = headers.Bits(bytes([0b10100110, 0b01000000]))
    assert (r.ue(), r.ue(), r.ue(), r.se()) == (0, 1, 2, 2)
    assert headers._rbsp(b"\x00\x00\x03\x01\x00\x00\x03") == \
        b"\x00\x00\x01\x00\x00"
    stream = (b"\x00\x00\x00\x01\x40\x01\xaa"
              b"\x00\x00\x01\x42\x01\x00\x00\x03\x01")
    assert headers.split_nals(stream) == [(32, b"\xaa"),
                                          (33, b"\x00\x00\x01")]
