"""The work the benchmark counts: the kernels' operations and bytes, the
model FLOPs and the calls a forward makes, against hand counts; the
trace's busy time and idle attribution on made-up events; and the host's
load read over a stretch of work."""

import threading
import time

import pytest

from portbench import hostload, model, roofline
from portbench.trace import Spans, Trace
from reference import nets

ASSP = {"reference": {"network": "EquiUnetASSPEvo", "kwargs": {"width": 48}},
        "precision": {"activations": "bfloat16"}}
EQUI = {"reference": {"network": "EquiUnet", "kwargs": {"width": 48}},
        "precision": {"activations": "bfloat16"}}


def test_conv_and_evonorm_work_by_hand():
    ops, nbytes = roofline.conv3x3x3_work((1, 8, 8, 8, 4, 6))
    assert ops == 2 * 512 * 27 * 4 * 6
    assert nbytes == 2 * (512 * 4 + 512 * 6 + 27 * 4 * 6) + 4 * 6
    ops, nbytes = roofline.evonorm_s0_work((2, 4, 4, 4, 8))
    assert ops == 11 * 128 * 8 and nbytes == 4 * 128 * 8 + 8 * 8
    t, by = roofline.bound(989e12, roofline.PEAK_BF16, 1.0)
    assert t == pytest.approx(1.0) and by == "operations"
    t, by = roofline.bound(1.0, roofline.PEAK_BF16, 3.35e12)
    assert t == pytest.approx(1.0) and by == "bytes"


def test_forward_flops_are_the_convolutions_and_linears_by_hand():
    shape = (1, 4, 16, 16, 16)
    for cfg in (ASSP, EQUI):
        small = {"reference": {"network": cfg["reference"]["network"], "kwargs": {"width": 4}}}
        hand = 0
        for m, inp, out in model.module_calls(small, shape, True,
                                              lambda m: isinstance(m, (nets.Conv, nets.Linear))):
            if isinstance(m, nets.Conv):
                k = m.kernel_size[0] ** 3
                hand += 2 * out[1] * out[2] * out[3] * out[4] * inp[1] * k
            else:
                hand += 2 * m.in_features * m.out_features
        assert model.count_flops(small, shape, True) == hand


def test_published_networks_at_the_served_shape():
    shape = (1, 4, 200, 200, 136)
    b1 = lambda m: isinstance(m, nets.Conv) and m.kernel_size == (3, 3, 3) and \
        m.dilation == (1, 1, 1)
    assert len(model.module_calls(ASSP, shape, False, b1)) == 14
    assert len(model.module_calls(EQUI, shape, False, b1)) == 15
    assert len(model.module_calls(ASSP, shape, False,
                                  lambda m: isinstance(m, nets.EvoNormS0))) == 21
    # about 4.4 TFLOP a served forward of EquiUnetASSPEvo, 5.2 of EquiUnet
    assert model.count_flops(ASSP, shape, False) == pytest.approx(4.383e12, rel=1e-3)
    assert model.count_flops(EQUI, shape, False) == pytest.approx(5.176e12, rel=1e-3)


def test_busy_time_and_idle_attribution():
    s = 10 ** 9
    tr = Trace(0, 10 * s, [("a", 1 * s, 3 * s), ("b", 2 * s, 4 * s), ("a", 6 * s, 7 * s)])
    assert tr.busy_s == pytest.approx(4.0)
    assert tr.top_ops() == [["a", 3.0], ["b", 2.0]]
    spans = Spans()
    spans.items += [("MainThread", "wait", 0, 2 * s), ("MainThread", "step", 4 * s, 5 * s),
                    ("other", "decode", 0, 10 * s)]
    idle = dict((k, v) for k, v in tr.idle_by_span(spans))
    assert idle == pytest.approx({"wait": 1.0, "step": 1.0, "outside spans": 4.0})


def test_host_load_by_thread():
    a = hostload.snapshot()
    assert a is not None

    stop = threading.Event()

    def spin():
        x = 0
        while not stop.is_set():
            x += 1

    t = threading.Thread(target=spin, name="spinner")
    t.start()
    time.sleep(0.3)
    b = hostload.snapshot()      # while the spinner is alive
    stop.set()
    t.join()
    line = hostload.report(a, b)
    assert "spinner" in line and "MainThread" in line
    assert "steal" in line or "not counted" in line
    idle = dict(b, machine={k: 0.0 for k in b["machine"]})
    assert "not counted" in hostload.report(dict(a, machine=idle["machine"]), idle)
