"""The Swin UNETR cell's files and the work it counts, on the CPU: the cell
by name, the reference on the meta device (62.19 M parameters, 1.543
TFLOP a 128³ window, 1.367 of them in 20 3³ convolutions), the roofline
reader's work against hand counts, the sliding-window plan of
``reference/serve_sw.py`` against the program's, and the stitch of the
reference against the program's ``sliding_window_inference`` on a small
volume."""

import math

import pytest
import torch

from portbench import manifest, model

CELL = "swin_unetr_f48.serve_sw_tta"
WINDOW = (1, 4, 128, 128, 128)


def test_cell_loads_by_name():
    cell = manifest.load_cell(CELL)
    assert cell.chips == 1 and cell.kind.__name__ == "portbench_kind_backlog_sw"
    assert cell.config["cli"] == ["--model", "swin_unetr"] and cell.config["reduced"] == []
    assert [m["name"] for m in cell.end_to_end] == ["cases_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["window_attn_roofline.serve_sw",
                                                   "sw_idle_ms.serve_sw"]
    for m in cell.per_layer:
        assert manifest.metric_reader(m["name"]) is not None
    assert cell.traffic["roi"] == [128, 128, 128] and cell.traffic["sw_batch_size"] == 2
    assert "label_margin" in cell.limits


def test_reference_on_meta_is_the_published_network():
    cfg = manifest.load_cell(CELL).config
    net = model.meta_network(cfg)
    assert sum(p.numel() for p in net.parameters()) == cfg["parameters"] == 62_191_941
    assert model.count_flops(cfg, WINDOW, False) == pytest.approx(1.543e12, rel=1e-3)
    b1 = manifest.metric_reader("conv3x3x3_roofline.serve")
    convs = model.module_calls(cfg, WINDOW, False, b1.select)
    assert len(convs) == 20
    flops = sum(2 * math.prod(o[2:]) * o[1] * i[1] * 27 for _, i, o in convs)
    assert flops == pytest.approx(1.367e12, rel=1e-3)


def test_window_attn_work_by_hand():
    """At batch 1 a 128³ window runs 8 attention calls (4 stages × 2
    blocks) over 1000, 125, 27 and 8 windows of 343 tokens with 3, 6, 12
    and 24 heads of 16: 1.004 G exponentials, 64.2 GFLOP, 375 MB; the
    exponentials bound it at 0.257 ms."""
    cfg = manifest.load_cell(CELL).config
    reader = manifest.metric_reader("window_attn_roofline.serve_sw")
    calls = model.module_calls(cfg, WINDOW, False, reader.select)
    assert [c[1] for c in calls] == [(w, h, 343, 16) for w, h in
                                     ((1000, 3), (125, 6), (27, 12), (8, 24)) for _ in (0, 1)]
    exps = flops = nbytes = 0.0
    for _, inp, _ in calls:
        e, f, b = reader.work(inp)
        exps, flops, nbytes = exps + e, flops + f, nbytes + b
    hand = 2 * 343 ** 2 * (1000 * 3 + 125 * 6 + 27 * 12 + 8 * 24)
    assert exps == hand == pytest.approx(1.004e9, rel=1e-3)
    assert flops == 4 * 16 * hand == pytest.approx(64.2e9, rel=1e-3)
    assert nbytes == pytest.approx(374.6e6, rel=1e-3)
    assert reader.least_seconds(calls) == pytest.approx(hand / 3.9e12)
    two = model.module_calls(cfg, (2, 4, 128, 128, 128), False, reader.select)
    assert reader.least_seconds(two) == pytest.approx(2 * hand / 3.9e12)


@pytest.mark.parametrize("shape", [(200, 200, 136), (200, 136, 200), (136, 200, 200)])
def test_window_plan_matches_the_program(shape):
    """200×200×136, the padded served case, and its TTA axis orders: 8
    windows of 128³ each, the same starts as the program's plan."""
    from brats21_tpu_torch.ops.sliding_window import window_plan
    from reference import serve_sw
    pads, starts = serve_sw.plan(shape, (128, 128, 128))
    roi, ppads, pstarts = window_plan(shape, (128, 128, 128))
    assert len(starts) == 8 and [tuple(s) for s in pstarts.tolist()] == starts
    assert [tuple(p) for p in ppads] == pads


def test_reference_stitch_matches_the_program():
    """Constant weights over a volume smaller than the roi on one axis
    (padded half before) and larger on the others: the reference's stitch
    against the program's ``sliding_window_inference`` with a linear
    predictor."""
    from brats21_tpu_torch.ops.sliding_window import sliding_window_inference
    from reference import serve_sw
    torch.manual_seed(0)
    x = torch.randn((1, 2, 20, 11, 27))
    w = torch.randn((3, 2, 1, 1, 1))

    def net(v, with_deep=False):
        return torch.nn.functional.conv3d(v, w) + v.sum() * 1e-3

    want = serve_sw.stitched_logits(net, x, (16, 16, 16))
    got = sliding_window_inference(x.permute(0, 2, 3, 4, 1), (16, 16, 16),
                                   lambda v: net(v.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1),
                                   sw_batch_size=1)
    torch.testing.assert_close(got.permute(0, 4, 1, 2, 3), want, atol=1e-5, rtol=1e-5)
