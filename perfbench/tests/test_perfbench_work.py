"""The yardstick's arithmetic: the kernels' work counts and bounds, the
busy union and idle gaps of a trace, the readers on a synthetic record,
and the reference's FLOPs per image."""

import pytest

from perfbench import harness, roofline, trace
from perfbench.harness import Record

K = Record(window_s=1.0)


@pytest.mark.parametrize("kernel, batch, src, dst, nbytes, bound_us", [
    ("k2", 64, (150, 150), (299, 299), 19_324_992, 5.77),
    ("k1", 64, (256, 256), (224, 224), 22_216_704, 6.63),
    ("k1", 128, (512, 512), (299, 299), 134_993_280, 40.3),
])
def test_kernel_bytes_and_bound(kernel, batch, src, dst, nbytes, bound_us):
    got, flops = K.kernel(kernel).work(batch, src, dst)
    assert got == nbytes
    # bytes bind these calls: the fp32 arithmetic is well under them
    assert flops / roofline.FP32_FLOPS_PER_S < nbytes / \
        roofline.HBM_BYTES_PER_S
    assert roofline.bound_s(got, flops) * 1e6 == pytest.approx(bound_us,
                                                               abs=0.005)


def test_busy_union_counts_overlap_once_and_finds_gaps():
    ops = [("a", 0.1, 0.3), ("b", 0.2, 0.4), ("c", 0.4, 0.5),
           ("d", 0.7, 0.75), ("e", 0.71, 0.72)]
    busy, gaps = trace.union(ops, 1.0)
    assert busy == pytest.approx(0.45)
    assert gaps == [(0.0, 0.1), (0.5, 0.7), (0.75, 1.0)]


def test_gap_labels_take_the_innermost_span():
    gaps = [(0.0, 0.1), (0.5, 0.7), (0.75, 1.0), (0.8, 0.800001)]
    spans = [("runner.run", 0.45, 0.8), ("dispatch", 0.49, 0.6)]
    got = {label.split(" (")[0]: total
           for label, total in trace.label_gaps(gaps, spans)}
    assert got["dispatch"] == pytest.approx(0.2)
    assert got["runner.run"] == pytest.approx(0.25)
    assert got["host"] == pytest.approx(0.1)
    assert got["gaps under 10 us"] == pytest.approx(1e-6)


def test_top_ops_sum_by_name():
    ops = [("k", 0.0, 0.1), ("m", 0.1, 0.15), ("k", 0.2, 0.3)]
    assert trace.top_ops(ops) == [["k", pytest.approx(0.2)],
                                  ["m", pytest.approx(0.05)]]


def _reader(name):
    return harness.load_module(f"{harness.HERE}/metrics/{name}.py")


def test_readers_on_a_synthetic_record():
    bound = roofline.bound_s(*K.kernel("k2").work(64, (150, 150),
                                                  (299, 299)))
    rec = Record(
        window_s=2.0, images=128, batches=2,
        counters={"engine.busy_seconds": 0.064, "device.run_seconds": 1.5},
        runner={"bytes_staged": 128 * 33750},
        device_ops=[("yuv420_kernel<true>", 0.0, 2 * bound),
                    ("void cudnn_conv", 0.1, 0.12),
                    ("Memcpy HtoD (Pinned -> Device)", 0.2, 0.25),
                    ("yuv420_kernel<true>", 1.0, 1.0 + 2 * bound)],
        busy_s=0.5, geometry={"batch": 64, "src_hw": [150, 150],
                              "dst_hw": [299, 299]},
        flops_per_image=11.42e9, plain_images=512, plain_s=4.0)
    assert _reader("runner.wall_share").read(rec) == pytest.approx(75.0)
    assert _reader("runner.staged_bytes_per_image").read(rec) == 33750
    assert _reader("k2.roofline_pct").read(rec) == pytest.approx(50.0)
    assert _reader("k1.roofline_pct").read(rec) is None
    assert _reader("model.device_ms_per_batch").read(rec) == \
        pytest.approx(10.0)
    # the untraced passes: 128 images/s at 11.42 GFLOP an image
    assert _reader("model.mfu").read(rec) == pytest.approx(
        100 * 11.42e9 * 128 / 989e12)
    # 0.5 busy s over 128 images, at 128 images/s: busy 50%
    assert _reader("device.idle_pct.batch").read(rec) == pytest.approx(50)
    empty = Record(window_s=1.0)
    for name in ("model.mfu", "device.idle_pct.batch",
                 "model.device_ms_per_batch", "k1.roofline_pct"):
        assert _reader(name).read(empty) is None


@pytest.mark.parametrize("workload, gflop", [
    ("inceptionv3.packed_yuv420_150", 11.42),
    ("resnet50.packed_rgb256", 7.72),
])
def test_reference_flops_per_image(workload, gflop):
    from perfbench.run import flops_per_image
    got = flops_per_image(harness.resolve(workload)) / 1e9
    assert got == pytest.approx(gflop, rel=0.005)
