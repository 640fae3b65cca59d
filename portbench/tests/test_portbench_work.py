"""The operation and byte counts of ``portbench/work.py`` against hand counts."""

from __future__ import annotations

import pytest

from portbench import cells, work

R18 = "r18-cifar10.fb1-c4096"
R152 = "r152-cifar10.gradreg-c512"


def _stage(p, h, n, cin, s):
    """Multiply-adds of a bottleneck stage of ``n`` blocks at ``p`` planes,
    output side ``h``, input channels ``cin``, stride ``s``, downsample C."""
    first = (h * s) ** 2 * cin * p + h * h * 9 * p * p + h * h * 4 * p * p + h * h * cin * 4 * p
    return first + (n - 1) * (h * h * 4 * p * p + h * h * 9 * p * p + h * h * 4 * p * p)


def test_resnet18_forward_macs_by_hand():
    stem = 32 * 32 * 27 * 64
    stage1 = 4 * 32 * 32 * 64 * 576
    # a later stage: the strided 3x3, three more 3x3s, the 1x1 shortcut
    stage = (18_874_368 + 3 * 37_748_736 + 2_097_152)
    assert stem + stage1 + 3 * stage + 512 * 10 == 555_422_720
    assert work.forward_macs(cells.find(R18).config) == 555_422_720


def test_resnet152_forward_macs_by_hand():
    macs = (32 * 32 * 27 * 64 + _stage(64, 32, 3, 64, 1) + _stage(128, 16, 8, 256, 2)
            + _stage(256, 8, 36, 512, 2) + _stage(512, 4, 3, 1024, 2) + 2048 * 10)
    assert macs == 3_722_137_600
    assert work.forward_macs(cells.find(R152).config) == macs


@pytest.mark.parametrize("workload, passes", [(R18, 1), (R152, 2)])
def test_model_flops_are_three_products_a_pass_less_the_stem_input_gradient(workload, passes):
    cell = cells.find(workload)
    w = work.step_work(cell.config, cell.traffic["recipe"])
    stem = 32 * 32 * 27 * 64
    per_image = 2 * (3 * work.forward_macs(cell.config) - stem) * passes
    assert w["model_flops"] == pytest.approx(per_image * w["images"], rel=1e-12)
    assert w["conv_flops"] < w["model_flops"]


def test_layout_drops_the_rows_past_the_last_block():
    assert work.layout(cells.find(R18).config, cells.find(R18).traffic["recipe"]) == (12, 4096)
    assert work.layout(cells.find(R152).config, cells.find(R152).traffic["recipe"]) == (4, 512)


def test_bn_bytes_by_hand():
    """ResNet-18, bf16, one chunk of 4096: per layer 5 passes of M x C x 2
    bytes; stages (H*W, C, BNs) = (1024, 64, 5), (256, 128, 5), (64, 256,
    5), (16, 512, 5) counting the stem and the shortcuts' BNs."""
    cell = cells.find(R18)
    w = work.step_work(cell.config, cell.traffic["recipe"])
    chunk = sum(5 * 4096 * hw * c * 2 * n for hw, c, n in
                ((1024, 64, 5), (256, 128, 5), (64, 256, 5), (16, 512, 5)))
    assert w["bn_bytes"] == 12 * chunk
    assert w["bn_min_s"] == pytest.approx(12 * chunk / 3.35e12)


def test_conv_roofline_time_of_one_layer_by_hand():
    """The first stage's 3x3 convolution in bf16 at 2048 images: 154.6
    GFLOP against 989 TFLOP/s, 537 MB against 3.35 TB/s; bytes bound it."""
    flops = 2.0 * 64 * 64 * 9 * 1024 * 2048
    nbytes = 2 * (2 * 2048 * 1024 * 64 + 64 * 64 * 9)
    assert nbytes / 3.35e12 > flops / 989e12
    one = {"model.depth": 18, "model.width": 64, "data.channels": 64, "data.classes": 10,
           "data.pixels": 32, "data.size": 2048}
    recipe = {"data.batch_size": 2048, "hyp.sub_batch": 2048, "impl.mixed_precision": True}
    # the stem of a 64-channel input is such a layer, with no input gradient
    w = work.step_work(one, recipe)
    assert w["conv_min_s"] > 2 * nbytes / 3.35e12


def test_peaks_follow_the_compute_dtype():
    assert work.compute_dtype({"impl.mixed_precision": True}) == "bfloat16"
    assert work.compute_dtype({"impl.mixed_precision": False}) == "float32"
    assert work.compute_dtype({"impl.compute_dtype": "float16"}) == "float16"
    assert work.PEAK_FLOPS["bfloat16"] == 989e12 and work.PEAK_FLOPS["float32"] == 67e12
