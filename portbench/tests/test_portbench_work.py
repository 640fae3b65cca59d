"""The operation and byte counts of ``portbench/work.py`` against hand counts,
and against the counts each cell was measured with."""

from __future__ import annotations

import pytest

from portbench import cells, work
from portbench.tests.test_portbench_reference import densenet_cell

R18 = "r18-cifar10.fb1-c4096"
R152 = "r152-cifar10.gradreg-c512"

# each cell's work as it was counted before the model families were found
# by name, to the last bit
WORK = {
    R18: {"images": 49152, "dtype": "bfloat16", "peak_flops": 989000000000000.0,
          "model_flops": 163626879025152.0, "conv_flops": 163625369075712.0,
          "conv_min_s": 0.17897995618582213, "bn_bytes": 301989888000.0,
          "bn_min_s": 0.0901462352238806},
    R152: {"images": 2048, "dtype": "float32", "peak_flops": 67000000000000.0,
           "model_flops": 91460758142976.0, "conv_flops": 91460254826496.0,
           "conv_min_s": 1.3657015912845407, "bn_bytes": 587202560000.0,
           "bn_min_s": 0.17528434626865672},
}


@pytest.mark.parametrize("workload", WORK)
def test_work_is_counted_as_before(workload):
    cell = cells.find(workload)
    assert work.step_work(cell.config, cell.traffic["recipe"]) == WORK[workload]


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
    one = dict(cells.find(R18).config, **{"data.channels": 64, "data.size": 2048})
    recipe = {"data.batch_size": 2048, "hyp.sub_batch": 2048, "impl.mixed_precision": True}
    # the stem of a 64-channel input is such a layer, with no input gradient
    w = work.step_work(one, recipe)
    assert w["conv_min_s"] > 2 * nbytes / 3.35e12


def test_peaks_follow_the_compute_dtype():
    assert work.compute_dtype({"impl.mixed_precision": True}) == "bfloat16"
    assert work.compute_dtype({"impl.mixed_precision": False}) == "float32"
    assert work.compute_dtype({"impl.compute_dtype": "float16"}) == "float16"
    assert work.PEAK_FLOPS["bfloat16"] == 989e12 and work.PEAK_FLOPS["float32"] == 67e12


def test_densenet121_work_by_hand():
    """120 BNs (two a dense layer, one a transition, the last), every
    convolution's three products but the stem's input gradient, and the
    classifier's, a chunk of 512 in float32, two passes under the penalty."""
    cell = densenet_cell()
    recipe = cell.traffic["recipe"]
    layers = list(work.model_layers(cell.config))
    convs = [l for l in layers if l[0] == "conv"]
    bns = [l for l in layers if l[0] == "bn"]
    assert len(bns) == 120 and len(convs) == 120 and convs[0][1] == "stem_conv0"
    assert [l[0] for l in layers].count("pool") == 3

    def macs(layer):
        _, _, cin, cout, k, stride, h = layer
        return cout * cin * k * k * (h // stride) ** 2
    # the stem's 3x3 on the image; a dense layer of block b at side h and
    # input c: 1x1 c -> 128, 3x3 128 -> 32; transitions c -> c / 2
    assert macs(convs[0]) == 3 * 64 * 9 * 32 * 32
    forward = sum(macs(c) for c in convs) + 1024 * 10
    assert work.forward_macs(cell.config) == forward
    w = work.step_work(cell.config, recipe)
    chunks = 2048 // 512
    assert w["images"] == chunks * 512 and w["dtype"] == "float32"
    assert w["model_flops"] == pytest.approx(
        2 * 2 * 512 * chunks * (3 * forward - macs(convs[0])), rel=1e-12)
    assert w["bn_bytes"] == 2 * chunks * sum(5 * 512 * h * h * c * 4 for _, _, c, h in bns)
    side = {}
    for _, name, c, h in bns:
        side.setdefault(h, []).append(c)
    # blocks of 6, 12, 24 and 16 layers at 32, 16, 8 and 4 pixels, the
    # transitions' BNs at the side of the block before them, the last at 4
    assert {h: len(cs) for h, cs in side.items()} == {32: 13, 16: 25, 8: 49, 4: 33}
    assert max(side[4]) == 1024 and sorted(set(side[32]))[:3] == [64, 96, 128]
