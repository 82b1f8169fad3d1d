"""The FLOP and kernel-work counters against hand-worked shapes."""
import pytest

from portbench import common, flops
from portbench.peaks import least_seconds


def cfg():
    return common.load_json("configs", "faster-rcnn-r50-fpn-voc15-5-task2")


def test_resnet50_forward_flops_at_224():
    # torchvision's ResNet-50 at 224x224: 4.09e9 multiply-adds, of which the
    # 2048x1000 classifier takes 2.0e6; the first 53 layers are the trunk's
    layers = flops._layers(cfg(), {"batch": 1, "canvas": [224, 224]}, train=False)
    trunk = sum(f for f, _, _ in layers[:53])
    assert trunk == pytest.approx(2 * (4.089e9 - 2.048e6), rel=0.01)


def test_train_counts_gradients_above_the_frozen_stages():
    c, tr = cfg(), {"batch": 2, "canvas": [64, 64], "replay_prototypes": 15}
    layers = flops._layers(c, tr, train=True)
    fwd = sum(f for f, _, _ in layers)
    total = flops.step_flops(c, tr, train=True)
    # the stem and layer1 (10 convs) and the dense RPN head (10) get no gradient
    assert not any(g or t for _, g, t in layers[:11])
    assert fwd < total < 3 * fwd


def test_rpn_head_work_by_hand():
    mod = common.load_module("kernels", "rpn_head")
    nbytes, fl, dt = mod.work(B=1, H=2, W=3, C=4, F=8, P=5)
    assert fl == 2 * 6 * (9 * 4 * 8 + 8 * 5)
    assert nbytes == 6 * 4 * 2 + 6 * 5 * 2 + 9 * 4 * 8 * 2 + 8 * 4 + 8 * 5 * 2 + 5 * 4
    assert dt == "bfloat16"


def test_assign_and_nms_work_by_hand():
    a = common.load_module("kernels", "assign").work(B=2, N=10, G=4, V=3)
    assert a == (10 * 16 + 2 * 4 * 17 + 2 * 10 + 2 * 10 * 24, 3 * 10 * 29 + 2 * 10 * 16, "float32")
    n = common.load_module("kernels", "nms").work(B=2, N=10, max_out=3)
    assert n == (2 * (10 * 20 + 4 + 12 + 4), 0, "float32")


def test_least_seconds_takes_the_larger_bound():
    assert least_seconds(3.35e12, 0, "float32") == pytest.approx(1.0)
    assert least_seconds(0, 989e12, "bfloat16") == pytest.approx(1.0)
    assert least_seconds(3.35e12, 2 * 67e12, "float32") == pytest.approx(2.0)


def test_leaf_gap_and_detection_gaps():
    g, leaf = common.leaf_gap({"a": 1.1, "b": 0.0, "c": 2.0}, {"a": 1.0, "b": 1e-9, "c": 2.0})
    assert leaf == "a" and g == pytest.approx(0.1)
    # against a given median: the tiny leaf's gap is taken over it
    g, leaf = common.leaf_gap({"a": 1.0, "b": 0.5}, {"a": 1.0, "b": 1e-9}, 2.0)
    assert leaf == "b" and g == pytest.approx(0.25)
    import numpy as np

    box = np.array([[0, 0, 10, 10]], np.float32)
    d = {"boxes": box, "scores": np.array([0.9], np.float32), "labels": np.array([3])}
    g = common.detection_gaps([d], [d], 100, 0.05)
    assert g["missed"] == 0.0 and g["missed_top"] == 0.0
    shifted = dict(d, boxes=np.array([[1, 0, 11, 10]], np.float32), scores=np.array([0.89], np.float32))
    assert common.detection_gaps([shifted], [d], 100, 0.05)["missed_top"] == 0.0
    other = dict(d, labels=np.array([4]))
    g = common.detection_gaps([other], [d], 100, 0.05)
    assert g["missed_top"] == 1.0 and g["missed"] == 1.0
