"""Model FLOPs of one step, from the configuration's shapes.

Forward convolution and matrix-product FLOPs (2 per multiply-add) of
ResNet-50, the FPN, the RPN head, the bbox head and the mask head at the
cell's batch and canvas. A train step adds the input gradient of every
layer whose input carries one (everything above the frozen stages; not
the dense RPN head, which runs forward only under the sparse RPN loss)
and the weight gradient of every trainable layer. No recomputation is
counted, nor the teacher, whose detections the step is fed.
"""
from __future__ import annotations

from typing import List, Tuple


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _layers(cfg: dict, traffic: dict, train: bool) -> List[Tuple[float, bool, bool]]:
    """(forward FLOPs, input carries a gradient, trainable) per layer."""
    B = traffic["batch"]
    H, W = traffic["canvas"]
    out: List[Tuple[float, bool, bool]] = []

    def conv(h, w, cin, cout, k, s, p, grad_in, trainable):
        ho, wo = _out(h, k, s, p), _out(w, k, s, p)
        out.append((2.0 * B * ho * wo * cout * cin * k * k, grad_in, trainable))
        return ho, wo

    h, w = conv(H, W, 3, 64, 7, 2, 3, False, False)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin, maps = 64, []
    frozen = cfg["frozen_stages"]
    for s, n in enumerate(cfg["backbone_blocks"]):
        mid = 64 * 2 ** s
        tr = s + 1 > frozen
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            gin = tr and not (b == 0 and s == frozen)  # the first trainable block's input is cut
            conv(h, w, cin, mid, 1, 1, 0, gin, tr)
            h2, w2 = conv(h, w, mid, mid, 3, stride, 1, tr, tr)
            conv(h2, w2, mid, mid * 4, 1, 1, 0, tr, tr)
            if b == 0:
                conv(h, w, cin, mid * 4, 1, stride, 0, gin, tr)
            h, w, cin = h2, w2, mid * 4
        maps.append((h, w, cin, s + 1 > frozen))
    C = cfg["fpn_channels"]
    levels = []
    for i, (h, w, c, tr) in enumerate(maps):
        conv(h, w, c, C, 1, 1, 0, tr, True)
        levels.append((h, w))
    for h, w in levels:
        conv(h, w, C, C, 3, 1, 1, True, True)
    levels.append((_out(levels[-1][0], 1, 2, 0), _out(levels[-1][1], 1, 2, 0)))
    A = len(cfg["anchor_ratios"]) * len(cfg["anchor_scales"])
    for h, w in levels:  # the dense head: forward only on the train path
        conv(h, w, C, C, 3, 1, 1, False, False)
        conv(h, w, C, 5 * A, 1, 1, 0, False, False)
    nc = cfg["num_classes"]
    fc = cfg["fc_channels"]
    s = cfg["roi_out_size"]
    R = B * (cfg["rcnn_num"] if train else cfg["rpn_max_per_img"])

    def linear(n, i, o, grad_in):
        out.append((2.0 * n * i * o, grad_in, True))

    if train:  # the sparse RPN loss: the head at the sampled anchors
        S = B * cfg["rpn_num"]
        linear(S, 9 * C, C, True)
        linear(S, C, 5 * A, True)
    linear(R, C * s * s, fc, train)
    linear(R, fc, fc, True)
    linear(R, fc, nc + 1, True)
    linear(R, fc, 4 * nc, True)
    if train and traffic.get("replay_prototypes"):
        Pn = traffic["replay_prototypes"]
        linear(Pn, C * s * s, fc, False)
        linear(Pn, fc, fc, True)
        linear(Pn, fc, nc + 1, True)
        linear(Pn, fc, 4 * nc, True)
    if cfg.get("mask_convs") and train:
        m = cfg["mask_roi_out_size"]
        ch = cfg["mask_channels"]
        for i in range(cfg["mask_convs"]):
            out.append((2.0 * R * m * m * ch * (C if i == 0 else ch) * 9, True, True))
        out.append((2.0 * R * m * m * ch * ch * 4, True, True))  # 2x2 transposed conv
        out.append((2.0 * R * (2 * m) ** 2 * ch * nc, True, True))
    return out


def step_flops(cfg: dict, traffic: dict, train: bool) -> float:
    total = 0.0
    for f, grad_in, trainable in _layers(cfg, traffic, train):
        total += f
        if train:
            total += f * (grad_in + trainable)
    return total
