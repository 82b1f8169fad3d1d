"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs on a host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests).
Tolerances are those of chip_smoke.py: f32 within 1e-4 (convs) or 1e-5
(RoIAlign forward and backward) of the largest magnitude, bf16 within a
couple of bf16 ulps of it, NMS keep lists, anchor assignments and
gathered rows identical, the assignment's IoUs bit-equal; the bf16
convs and both RoIAlign kernels give the same bits on every call.
"""
import numpy as np
import pytest
import torch

from nsgp_repre_tpu_torch.ops import (_ext, assign_cuda, gather_cuda, nms, nms_cuda, roi_align,
                                      roi_align_cuda)
from nsgp_repre_tpu_torch.ops import rpn_head_cuda as rh

from nms_edge_pairs import edge_pairs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, dt, f32_rel=1e-4):
    got, ref = got.float(), ref.float()
    scale = ref.abs().max().item()
    tol = f32_rel * max(1.0, scale) if dt == torch.float32 else 2 ** -6 * scale
    err = (got - ref).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,F,relu", [((1, 37, 53, 64), 128, True),
                                          ((2, 19, 32, 256), 256, False),
                                          ((2, 76, 128, 256), 256, True),
                                          ((1, 1, 3, 32), 128, False)])
def test_conv3x3_kernel(dev, dt, shape, F, relu):
    g = torch.Generator().manual_seed(0)
    C = shape[-1]
    x = torch.randn(*shape, generator=g).to(dev, dt)
    w = (torch.randn(3, 3, C, F, generator=g) / (9 * C) ** 0.5).to(dev)
    b = (torch.randn(F, generator=g) * 0.1).to(dev)
    before = _ext.LAUNCHES["conv3x3"]
    got = rh.conv3x3(x, w, b, relu=relu)
    assert _ext.LAUNCHES["conv3x3"] == before + 1
    _close(got, rh.conv3x3_plain(x, w, b, relu), dt)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 38, 64, 256), (3, 5, 7, 256), (2, 19, 32, 256),
                                   (1, 152, 256, 256)])
def test_rpn_head_kernel(dev, dt, shape):
    g = torch.Generator().manual_seed(1)
    C = shape[-1]
    x = torch.randn(*shape, generator=g).to(dev, dt)
    w = (torch.randn(3, 3, C, 256, generator=g) / (9 * C) ** 0.5).to(dev)
    b = (torch.randn(256, generator=g) * 0.1).to(dev)
    wcr = (torch.randn(256, 15, generator=g) / 16).to(dev)
    bcr = (torch.randn(15, generator=g) * 0.1).to(dev)
    got = rh.rpn_head(x, w, b, wcr, bcr)
    assert got.shape == shape[:3] + (15,)
    _close(got, rh.rpn_head_plain(x, w, b, wcr, bcr), dt)


def test_conv_wrapper_rejects_unsupported_shapes(dev):
    x = torch.zeros(1, 4, 4, 12, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C % 8"):
        rh.conv3x3(x, torch.zeros(3, 3, 12, 128, device=dev), torch.zeros(128, device=dev))


def test_bf16_convs_are_deterministic(dev):
    """No split-K and no atomics: two calls of each bf16 kernel give the
    same bits."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 38, 64, 256, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(3, 3, 256, 256, generator=g) / 48).to(dev)
    b = (torch.randn(256, generator=g) * 0.1).to(dev)
    wcr = (torch.randn(256, 15, generator=g) / 16).to(dev)
    bcr = (torch.randn(15, generator=g) * 0.1).to(dev)
    assert torch.equal(rh.conv3x3(x, w, b), rh.conv3x3(x, w, b))
    assert torch.equal(rh.rpn_head(x, w, b, wcr, bcr), rh.rpn_head(x, w, b, wcr, bcr))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,C,M", [(4096, 1024, 5000), (300, 8, 77)])
def test_gather_kernel(dev, dt, N, C, M):
    g = torch.Generator().manual_seed(N + M)
    table = torch.randn(N, C, generator=g).to(dev, dt)
    idx = torch.randint(-7, N + 7, (M,), generator=g, dtype=torch.int32).to(dev)
    before = _ext.LAUNCHES["gather"]
    got = gather_cuda.gather_rows(table, idx)
    assert _ext.LAUNCHES["gather"] == before + 1
    assert torch.equal(got, gather_cuda.gather_rows_plain(table, idx))


def _nms_inputs(seed, B, N, ties):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(B, N, 2, generator=g) * 300
    wh = torch.rand(B, N, 2, generator=g) * 80 + 4
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.rand(B, N, generator=g)
    if ties:
        scores = (scores * 8).round() / 8
        boxes[:, 1::5] = boxes[:, ::5][:, : boxes[:, 1::5].shape[1]]
    valid = torch.rand(B, N, generator=g) > 0.2
    idxs = torch.randint(0, 5, (B, N), generator=g, dtype=torch.int32)
    return boxes, scores, valid, idxs


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("B,N,max_out", [(1, 8304, 1000), (3, 700, 50), (2, 65, 200),
                                         (2, 20_000, 100)])
def test_nms_kernel(dev, ties, B, N, max_out):
    """N not a multiple of the 64-box row block, max_out above the valid
    count (N = 65), an image without candidates, two calls bit for bit."""
    boxes, scores, valid, idxs = (t.to(dev) for t in _nms_inputs(B + N, B, N, ties))
    valid[-1] = False  # an image without candidates
    ki, kv = nms_cuda.batched_nms(boxes, scores, idxs, valid, 0.6, max_out)
    again = nms_cuda.batched_nms(boxes, scores, idxs, valid, 0.6, max_out)
    pi, pv = nms.batched_nms(boxes, scores, idxs, valid, 0.6, max_out)
    assert torch.equal(kv, pv)
    assert torch.equal(ki, pi)  # valid slots and the zeros of unused ones
    assert torch.equal(again[0], ki) and torch.equal(again[1], kv)


@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_nms_kernel_threshold_edges(dev, thr):
    """Pairs at the IoU threshold and one ulp either side of it (the
    kernel's division-skip band), the later boxes meeting the earlier ones
    in the row block's triangle and through the kept set."""
    firsts, seconds, kinds = [], [], []
    for i, kind in enumerate(("at", "above", "below")):
        for j in range(12):
            slot = 12 * i + j
            a, b = edge_pairs(thr, 1, seed=slot, x0=150.0 * slot)[kind]
            firsts.append(torch.from_numpy(a[0]))
            seconds.append(torch.from_numpy(b[0]))
            kinds.append(kind)
    P = len(firsts)
    g = torch.Generator().manual_seed(5)
    boxes = torch.stack(firsts + seconds)[None].to(dev)
    scores = torch.cat([torch.rand(P, generator=g) * 0.1 + 0.9,
                        torch.rand(P, generator=g) * 0.4 + 0.1])[None].to(dev)
    valid = torch.ones(1, 2 * P, dtype=torch.bool, device=dev)
    ki, kv = nms_cuda.nms_kernel(boxes, scores, valid, thr, 2 * P)
    pi, pv = nms.nms(boxes, scores, valid, thr, 2 * P)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    kept = set(ki[0][kv[0]].tolist())
    assert [P + p in kept for p in range(P)] == [k != "above" for k in kinds]


def test_nms_kernel_keep_limit(dev):
    """max_out at the kept set's limit (every box kept: a grid of disjoint
    boxes), and one over it, which the wrapper refuses."""
    n = nms_cuda.MAX_KEEP + 100
    k = torch.arange(n, dtype=torch.float32)
    x, y = (k % 128) * 20, (k // 128) * 20
    boxes = torch.stack([x, y, x + 10, y + 10], -1)[None].to(dev)
    scores = torch.rand(1, n, generator=torch.Generator().manual_seed(6)).to(dev)
    valid = torch.ones(1, n, dtype=torch.bool, device=dev)
    ki, kv = nms_cuda.nms_kernel(boxes, scores, valid, 0.5, nms_cuda.MAX_KEEP)
    pi, pv = nms.nms(boxes, scores, valid, 0.5, nms_cuda.MAX_KEEP)
    assert int(kv.sum()) == nms_cuda.MAX_KEEP
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    with pytest.raises(ValueError, match="at most"):
        nms_cuda.nms_kernel(boxes, scores, valid, 0.5, nms_cuda.MAX_KEEP + 1)


def test_nms_kernel_iou_count(dev):
    """The walk's counting instantiation on disjoint boxes, all kept: each
    candidate meets every earlier keep once (the kept set is dealt over
    the cluster), and each of the cluster's blocks tests the row block's
    own pairs both ways; same keep list as the uncounted launch."""
    n = 1000
    k = torch.arange(n, dtype=torch.float32)
    boxes = torch.stack([(k % 40) * 20, (k // 40) * 20, (k % 40) * 20 + 10, (k // 40) * 20 + 10],
                        -1)[None].to(dev)
    scores = torch.rand(1, n, generator=torch.Generator().manual_seed(7)).to(dev)
    valid = torch.ones(1, n, dtype=torch.bool, device=dev)
    ki, kv, ious = nms_cuda.count_ious(boxes, scores, valid, 0.5, n)
    ref = nms_cuda.nms_kernel(boxes, scores, valid, 0.5, n)
    assert torch.equal(ki, ref[0]) and torch.equal(kv, ref[1]) and int(kv.sum()) == n
    rows = [min(64, n - s) for s in range(0, n, 64)]
    against_kept = sum(r * s for r, s in zip(rows, range(0, n, 64)))
    in_block = sum(r * (r - 1) for r in rows)
    cs, rest = divmod(ious - against_kept, in_block)
    assert rest == 0 and cs in (1, 2, 4, 8), (ious, against_kept, in_block)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_roi_align_kernel(dev, dt):
    g = torch.Generator().manual_seed(2)
    B, C, H, W = 2, 256, 160, 224
    feats = [torch.randn(B, H // s, W // s, C, generator=g).to(dev, dt) for s in (4, 8, 16, 32)]
    R = 300
    xy = torch.rand(R, 2, generator=g) * torch.tensor([W, H]) - 10
    side = torch.exp(torch.rand(R, 2, generator=g) * 4.5 + 2)
    rois = torch.cat([xy, xy + side], -1).to(dev)
    bidx = torch.randint(0, B, (R,), generator=g, dtype=torch.int32).to(dev)
    got = roi_align_cuda.multilevel_roi_align(feats, rois, bidx)
    ref = roi_align.multilevel_roi_align(feats, rois, bidx).to(dt)
    assert got.dtype == dt and got.shape == (R, 7, 7, C)
    if dt == torch.float32:
        _close(got, ref, dt, f32_rel=1e-5)
    else:
        assert (got.float() - ref.float()).abs().max().item() <= 2 ** -7 * ref.float().abs().max().item()


def test_small_predict_card_matches_cpu(dev):
    """A one-block-per-stage detector in f32: the card (kernels) and the
    CPU (plain versions) give the same detections."""
    from nsgp_repre_tpu_torch.engine.train import make_eval_step
    from nsgp_repre_tpu_torch.models.detector import DetectorConfig, FasterRCNN
    from nsgp_repre_tpu_torch.structures.sample import DetBatch, InstanceArray

    cfg = DetectorConfig(num_classes=6, task_split=(0, 4, 6), backbone_blocks=(1, 1, 1, 1),
                         rpn_nms_pre=256, rpn_max_per_img=96, max_per_img=24)
    cpu = FasterRCNN(cfg).init_weights(torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        for fc in cpu.bbox_head.fc_cls:
            fc.weight.mul_(5.0)
    card = FasterRCNN(cfg).eval()
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randint(0, 255, (1, 64, 96, 3)).astype(np.uint8))

    def batch(d):
        return DetBatch(images=img.to(d), img_shape=torch.tensor([[64, 96]], device=d),
                        ori_shape=torch.tensor([[64, 96]], device=d),
                        scale_factor=torch.ones(1, 2, device=d),
                        gt=InstanceArray(boxes=torch.zeros(1, 1, 4, device=d),
                                         labels=torch.full((1, 1), -1, device=d),
                                         valid=torch.zeros(1, 1, dtype=torch.bool, device=d)))

    _ext.reset_launches()
    got = make_eval_step(card)(batch(dev))
    assert dict(_ext.LAUNCHES) == {"conv3x3": 4, "rpn_head": 5, "nms": 2, "roi_align": 1,
                                   "roi_align_bwd": 0, "assign": 0, "gather": 0}
    ref = make_eval_step(cpu)(batch("cpu"))
    gv, rv = got.valid[0].cpu(), ref.valid[0]
    assert int(gv.sum()) == int(rv.sum()) > 0
    assert torch.equal(got.labels[0].cpu()[gv], ref.labels[0][rv])
    torch.testing.assert_close(got.scores[0].cpu()[gv], ref.scores[0][rv], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got.boxes[0].cpu()[gv], ref.boxes[0][rv], rtol=1e-3, atol=5e-2)


def _assign_inputs(seed, B, N, G, ties):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(N, 2, generator=g) * 900
    anchors = torch.cat([xy, xy + torch.rand(N, 2, generator=g) * 200 + 8], -1)
    gxy = torch.rand(B, G, 2, generator=g) * 800
    gt = torch.cat([gxy, gxy + torch.rand(B, G, 2, generator=g) * 300 + 16], -1)
    if ties and G == 1:
        gt[:, 0] = anchors[:B]  # a gt equal to an anchor (IoU 1)
    elif ties:
        gt[:, 1] = gt[:, 0]  # duplicated gt: argmax ties and claim ties
        gt[:, 2] = anchors[:B]  # a gt equal to an anchor (IoU 1)
    if G > 64:  # every slot a gt, but for one image with none
        gt_valid = torch.ones(B, G, dtype=torch.bool)
        gt_valid[-1] = False
    else:
        n_valid = torch.randint(1, 9, (B, 1), generator=g)
        gt_valid = torch.arange(G)[None] < n_valid
    prior_valid = torch.rand(B, N, generator=g) > 0.05
    return anchors, gt, gt_valid, prior_valid


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("B,N,G", [(4, 20_000, 64), (2, 777, 3), (3, 5001, 1), (3, 4096, 512)])
def test_assign_kernel(dev, ties, B, N, G):
    """G = 1 and G = 512 (the kernel's limit), N not a multiple of the
    1,024-anchor block (777, 5001), two calls bit for bit."""
    args = [t.to(dev) for t in _assign_inputs(B + N, B, N, G, ties)]
    before = _ext.LAUNCHES["assign"]
    got = assign_cuda.rpn_assign_targets(*args, 0.7, 0.3, 0.3)
    assert _ext.LAUNCHES["assign"] == before + 1
    again = assign_cuda.rpn_assign_targets(*args, 0.7, 0.3, 0.3)
    ref = assign_cuda.rpn_assign_targets_plain(*args, 0.7, 0.3, 0.3)
    assert torch.equal(got[0], ref[0])
    assert torch.equal(got[1], ref[1])  # bit-equal IoUs
    assert (got[0] >= 0).any()
    torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=1e-5)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_assign_wrapper_rejects_gt_slots_over_limit(dev):
    args = [t.to(dev) for t in _assign_inputs(3, 1, 100, assign_cuda.MAX_G + 1, False)]
    with pytest.raises(ValueError, match="gt slots"):
        assign_cuda.rpn_assign_targets(*args, 0.7, 0.3, 0.3)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_roi_align_bwd_kernel(dev, dt):
    """The backward kernel against the plain backward, and autograd
    through the wrapper launching it once."""
    g = torch.Generator().manual_seed(3)
    B, C, H, W = 2, 256, 160, 224
    level_hw = [(H // s, W // s) for s in (4, 8, 16, 32)]
    R = 300
    xy = torch.rand(R, 2, generator=g) * torch.tensor([W, H]) - 10
    side = torch.exp(torch.rand(R, 2, generator=g) * 4.5 + 2)
    rois = torch.cat([xy, xy + side], -1).to(dev)
    bidx = torch.randint(0, B, (R,), generator=g, dtype=torch.int32).to(dev)
    gout = torch.randn(R, 7, 7, C, generator=g).to(dev, dt)
    before = _ext.LAUNCHES["roi_align_bwd"]
    got = roi_align_cuda.multilevel_roi_align_backward(gout, rois, bidx, level_hw, B, dt)
    assert _ext.LAUNCHES["roi_align_bwd"] == before + 1
    ref = roi_align.multilevel_roi_align_backward(gout, rois, bidx, level_hw, B, dt)
    for x, y in zip(got, ref):
        assert x.dtype == dt and x.shape == y.shape
        if dt == torch.float32:
            _close(x, y, dt, f32_rel=1e-5)
        else:
            assert (x.float() - y.float()).abs().max().item() <= 2 ** -7 * y.float().abs().max().item()
    feats = [torch.zeros(B, h, w, C, device=dev, dtype=dt, requires_grad=True) for h, w in level_hw]
    roi_align_cuda.multilevel_roi_align(feats, rois, bidx).backward(gout)
    assert _ext.LAUNCHES["roi_align_bwd"] == before + 2
    for f, y in zip(feats, got):
        _close(f.grad, y, dt, f32_rel=1e-5)


def _roi_set(g, kind, B, R, H, W):
    """RoIs of ``kind``: proposal-like, or a quarter jittered around 1-8
    ground-truth boxes per image (the sampler's positives; hot tiles) and
    the rest proposal-like."""
    xy = torch.rand(R, 2, generator=g) * torch.tensor([W, H]) - 10
    side = torch.exp(torch.rand(R, 2, generator=g) * 4.5 + 2)
    rois = torch.cat([xy, xy + side], -1)
    bidx = torch.randint(0, B, (R,), generator=g, dtype=torch.int32)
    if kind == "clustered":
        gxy = torch.rand(B, 8, 2, generator=g) * torch.tensor([W, H]) * 0.8
        gt = torch.cat([gxy, gxy + torch.rand(B, 8, 2, generator=g) * 150 + 20], -1)
        n_gt = torch.randint(1, 9, (B,), generator=g)
        q = R // 4
        pick = (torch.rand(q, generator=g) * n_gt[bidx[:q].long()]).long()
        base = gt[bidx[:q].long(), pick]
        size = (base[:, 2:] - base[:, :2]).repeat(1, 2)
        rois[:q] = base + torch.randn(q, 4, generator=g) * 0.1 * size
    return rois, bidx


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind,ss,R", [("clustered", 2, 600), ("proposals", 1, 300),
                                       ("clustered", 1, 600), ("proposals", 2, 0)])
def test_roi_align_bwd_kernel_cases(dev, dt, kind, ss, R):
    """The backward kernel against the plain backward on clustered RoIs,
    at ss = 1 (the teacher's sample grid) and with no RoI at all (zero
    gradients); two calls give the same bits."""
    g = torch.Generator().manual_seed(7 + R + ss)
    B, C, H, W = 3, 256, 160, 224
    level_hw = [(H // s, W // s) for s in (4, 8, 16, 32)]
    rois, bidx = _roi_set(g, kind, B, R, H, W)
    rois, bidx = rois.to(dev), bidx.to(dev)
    gout = torch.randn(R, 7, 7, C, generator=g).to(dev, dt)
    got = roi_align_cuda.multilevel_roi_align_backward(gout, rois, bidx, level_hw, B, dt,
                                                       sampling_ratio=ss)
    again = roi_align_cuda.multilevel_roi_align_backward(gout, rois, bidx, level_hw, B, dt,
                                                         sampling_ratio=ss)
    for x, z, hw in zip(got, again, level_hw):
        assert x.dtype == dt and x.shape == (B, *hw, C)
        assert torch.equal(x, z)
    if R == 0:  # (the plain version takes R >= 1)
        assert not any(x.any() for x in got)
        return
    ref = roi_align.multilevel_roi_align_backward(gout, rois, bidx, level_hw, B, dt,
                                                  sampling_ratio=ss)
    for x, y in zip(got, ref):
        if dt == torch.float32:
            _close(x, y, dt, f32_rel=1e-5)
        else:
            assert (x.float() - y.float()).abs().max().item() <= 2 ** -7 * y.float().abs().max().item()


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_roi_align_kernels_are_deterministic(dev, dt):
    """No atomics on data: two calls of the forward and of the backward
    give the same bits."""
    g = torch.Generator().manual_seed(5)
    B, C, H, W = 2, 256, 160, 224
    level_hw = [(H // s, W // s) for s in (4, 8, 16, 32)]
    rois, bidx = _roi_set(g, "clustered", B, 400, H, W)
    rois, bidx = rois.to(dev), bidx.to(dev)
    feats = [torch.randn(B, h, w, C, generator=g).to(dev, dt) for h, w in level_hw]
    gout = torch.randn(400, 7, 7, C, generator=g).to(dev, dt)
    assert torch.equal(roi_align_cuda.roi_align_forward(feats, rois, bidx),
                       roi_align_cuda.roi_align_forward(feats, rois, bidx))
    a = roi_align_cuda.multilevel_roi_align_backward(gout, rois, bidx, level_hw, B, dt)
    b = roi_align_cuda.multilevel_roi_align_backward(gout, rois, bidx, level_hw, B, dt)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_roi_align_kernel_train_shape(dev, dt):
    """The forward at the training step's shape: 512 RoIs on each of 16
    608x1024 canvases, batch indices in any order."""
    g = torch.Generator().manual_seed(6)
    B, C, H, W = 16, 256, 608, 1024
    level_hw = [(H // s, W // s) for s in (4, 8, 16, 32)]
    rois, bidx = _roi_set(g, "clustered", B, 512 * B, H, W)
    rois, bidx = rois.to(dev), bidx.to(dev)
    feats = [torch.randn(B, h, w, C, generator=g).to(dev, dt) for h, w in level_hw]
    got = roi_align_cuda.multilevel_roi_align(feats, rois, bidx)
    ref = roi_align.multilevel_roi_align(feats, rois, bidx).to(dt)
    if dt == torch.float32:
        _close(got, ref, dt, f32_rel=1e-5)
    else:
        assert (got.float() - ref.float()).abs().max().item() <= 2 ** -7 * ref.float().abs().max().item()


@pytest.mark.parametrize("ss", [1, 2])
def test_roi_footprints_kernel_matches_plain(dev, ss):
    """The backward's binning rule on the card equals its plain version."""
    g = torch.Generator().manual_seed(8)
    level_hw = [(152, 256), (76, 128), (38, 64), (19, 32)]
    rois, _ = _roi_set(g, "clustered", 4, 2000, 608, 1024)
    rois[:50] = rois[:50] * 3 - 900  # some wholly outside
    rois[50:60, 2:] = rois[50:60, :2]  # zero area
    rois = rois.to(dev)
    lk, bk = roi_align_cuda.roi_footprints(level_hw, rois, sampling_ratio=ss)
    lp, bp = roi_align.roi_footprints(level_hw, rois, sampling_ratio=ss)
    assert torch.equal(lk, lp) and torch.equal(bk, bp)


def test_roi_align_wrappers_reject_unsupported_shapes(dev):
    rois = torch.tensor([[0.0, 0.0, 20.0, 20.0]], device=dev)
    bidx = torch.zeros(1, dtype=torch.int32, device=dev)
    feats = [torch.zeros(1, 8, 8, 12, device=dev, dtype=torch.bfloat16)]
    with pytest.raises(ValueError, match="C % 8"):
        roi_align_cuda.roi_align_forward(feats, rois, bidx, strides=(4,))
    gout = torch.zeros(1, 7, 7, 48, device=dev)
    with pytest.raises(ValueError, match="C % 32"):
        roi_align_cuda.multilevel_roi_align_backward(gout, rois, bidx, [(8, 8)], 1, strides=(4,))


def test_forward_only_kernels_refuse_grad(dev):
    x = torch.zeros(1, 4, 4, 32, device=dev, requires_grad=True)
    w = torch.zeros(3, 3, 32, 32, device=dev)
    with pytest.raises(RuntimeError, match="forward only"):
        rh.conv3x3(x, w, torch.zeros(32, device=dev))


def test_small_train_step_card_matches_cpu(dev):
    """The task-1 loss and backward of a one-block-per-stage detector in
    f32 at batch 2, on the card (kernels) and on the CPU (plain versions)
    from the same weights and priorities: the loss terms within 1e-4
    relative and every gradient within 1e-3 of its largest magnitude
    (cuDNN and the CPU sum in other orders; the RoI head runs on the
    card's proposals on both sides). Then two make_train_step steps on
    the card launch every training kernel once per step."""
    from nsgp_repre_tpu_torch.engine.runner import build_train_optimizer
    from nsgp_repre_tpu_torch.engine.train import TrainState, make_train_step
    from nsgp_repre_tpu_torch.models.detector import FasterRCNN
    from nsgp_repre_tpu_torch.testing import demo_det_batch, split_loss_and_grads, tiny_detector_config
    from nsgp_repre_tpu_torch.utils.config import load_config

    cfg = tiny_detector_config(rpn_num=64, rcnn_num=32)
    cpu = FasterRCNN(cfg).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.rpn_head.rpn_cls.weight.mul_(20.0)
    card = FasterRCNN(cfg)
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    batch = demo_det_batch(2, 64, 96, num_instances=(2, 3), num_classes=2, gt_capacity=4, seed=1)
    n = sum(-(-64 // s) * -(-96 // s) * cfg.num_base_priors for s in cfg.anchor_strides)
    pg = torch.Generator().manual_seed(5)
    pri = {"rpn": torch.rand(2, n, generator=pg), "roi": torch.rand(2, 4 + cfg.rpn_max_per_img, generator=pg)}
    pri["roi2"] = torch.rand(pri["roi"].shape, generator=pg)
    _ext.reset_launches()
    got_l, got_g, props = split_loss_and_grads(card, batch, pri)
    launches = dict(_ext.LAUNCHES)
    ref_l, ref_g, _ = split_loss_and_grads(cpu, batch, pri, proposals=props)
    assert launches["assign"] == 1 and launches["roi_align"] == 1 and launches["roi_align_bwd"] == 1
    for k in ref_l:
        assert abs(got_l[k] - ref_l[k]) <= 1e-4 * max(abs(ref_l[k]), 1e-3), (k, got_l[k], ref_l[k])
    assert got_g.keys() == ref_g.keys()
    for k in ref_g:
        scale = ref_g[k].abs().max().item()
        assert (got_g[k] - ref_g[k]).abs().max().item() <= 1e-3 * max(scale, 1e-6), k

    opt = build_train_optimizer(load_config("cl_faster_rcnn_cfgs/incremental_task/"
                                            "cl_faster_rcnn_nsgp_repre_15_5_1.py"), card, 10)
    step = make_train_step(card, opt)
    state = TrainState(opt)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        _ext.reset_launches()
        state, metrics = step(state, batch.to(dev), gen)
        assert all(torch.isfinite(v).item() for v in metrics.values())
        assert dict(_ext.LAUNCHES) == {"conv3x3": 0, "rpn_head": 5, "nms": 1, "roi_align": 1,
                                       "roi_align_bwd": 1, "assign": 1, "gather": 0}



def test_small_task2_step_card_matches_cpu(dev):
    """The task-2 loss (the card teacher's detections merged into both
    devices' gt sets, prototype replay, EWC) and its backward in f32 at
    batch 2, card against CPU: loss terms within 1e-4 relative, every
    gradient within 1e-3 of its largest magnitude (the train-step test's
    rule). Then two make_train_step steps on the card with the teacher in
    the step launch the kernels of both models: the teacher's predict
    (proposal and multiclass NMS, RoIAlign) and the student's step."""
    from nsgp_repre_tpu_torch.engine import ewc
    from nsgp_repre_tpu_torch.engine.pseudo import merge_pseudo_labels
    from nsgp_repre_tpu_torch.engine.runner import build_teacher, build_train_optimizer
    from nsgp_repre_tpu_torch.engine.train import TrainState, make_teacher_step, make_train_step
    from nsgp_repre_tpu_torch.models.detector import FasterRCNN
    from nsgp_repre_tpu_torch.testing import (demo_det_batch, split_loss_and_grads,
                                              tiny_detector_config)
    from nsgp_repre_tpu_torch.utils.config import load_config

    # a tiny task-2 student and its teacher on the CPU and on the card (the
    # same weights), prototypes, EWC terms and a batch
    cfg = tiny_detector_config(rpn_num=64, rcnn_num=32, task_id=2)
    cpu = FasterRCNN(cfg).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.rpn_head.rpn_cls.weight.mul_(20.0)
        for fc in cpu.bbox_head.fc_cls:
            fc.weight.mul_(30.0)
    models = {}
    g = torch.Generator().manual_seed(3)
    protos = torch.randn(4, 12544, generator=g)
    labels = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    for where in ("cpu", dev):
        m = FasterRCNN(cfg)
        m.load_state_dict(cpu.state_dict())
        m.to(where)
        teacher = build_teacher(m)
        with torch.no_grad():  # the student moved off the teacher, so EWC counts
            for n, p in m.named_parameters():
                if ewc.is_ewc_param(n):
                    p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(len(n)))
                          .to(where) * 0.05)
        params = {n: p for n, p in teacher.named_parameters()}
        imp = {k: torch.full_like(v, 1e-3) for k, v in ewc.init_importance(params).items()}
        models[str(where)] = (m, teacher, ewc.append_task_terms({}, imp, params))
    batch = demo_det_batch(2, 64, 96, num_instances=(2, 3), num_classes=2, gt_capacity=4, seed=1)
    card, card_teacher, card_terms = models[str(dev)]
    cpu, _, cpu_terms = models["cpu"]
    dets = make_teacher_step(card_teacher)(batch.to(dev))
    gts = merge_pseudo_labels(batch.gt.to(dev), dets, cfg.rpn_thresh, cfg.roi_thresh,
                              cfg.pseudo_iou_skip)
    assert int(gts[0].valid[:, 4:].sum()) > 0
    n = sum(-(-64 // s) * -(-96 // s) * cfg.num_base_priors for s in cfg.anchor_strides)
    pg = torch.Generator().manual_seed(5)
    G = gts[0].capacity
    pri = {"rpn": torch.rand(2, n, generator=pg),
           "roi": torch.rand(2, G + cfg.rpn_max_per_img, generator=pg)}
    pri["roi2"] = torch.rand(pri["roi"].shape, generator=pg)
    _ext.reset_launches()
    got_l, got_g, props = split_loss_and_grads(card, batch, pri, gts=gts,
                                               replay=(protos.to(dev), labels.to(dev)),
                                               ewc_terms=card_terms)
    launches = dict(_ext.LAUNCHES)
    ref_l, ref_g, _ = split_loss_and_grads(cpu, batch, pri, proposals=props,
                                           gts=tuple(x.to("cpu") for x in gts),
                                           replay=(protos, labels), ewc_terms=cpu_terms)
    assert launches["assign"] == 1 and launches["roi_align"] == 1 and launches["roi_align_bwd"] == 1
    assert ref_l["replay_loss_cls"] > 0 and ref_l["ewc_loss"] > 0
    for k in ref_l:
        assert abs(got_l[k] - ref_l[k]) <= 1e-4 * max(abs(ref_l[k]), 1e-3), (k, got_l[k], ref_l[k])
    assert got_g.keys() == ref_g.keys()
    for k in ref_g:
        scale = ref_g[k].abs().max().item()
        assert (got_g[k] - ref_g[k]).abs().max().item() <= 1e-3 * max(scale, 1e-6), k

    opt = build_train_optimizer(load_config("cl_faster_rcnn_cfgs/incremental_task/"
                                            "cl_faster_rcnn_nsgp_repre_15_5_2.py"), card, 10)
    state = TrainState(opt, teacher_params=dict(card_teacher.named_parameters()),
                       replay_feats=protos.to(dev), replay_labels=labels.to(dev),
                       ewc_terms=card_terms)
    step = make_train_step(card, opt, teacher_model=card_teacher)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        _ext.reset_launches()
        state, metrics = step(state, batch.to(dev), gen)
        assert all(torch.isfinite(v).item() for v in metrics.values())
        assert {"replay_loss_cls", "ewc_loss"} <= set(metrics)
        assert dict(_ext.LAUNCHES) == {"conv3x3": 0, "rpn_head": 5, "nms": 3, "roi_align": 2,
                                       "roi_align_bwd": 1, "assign": 1, "gather": 0}


def test_small_cov_step_card_matches_cpu(dev):
    """make_cov_step in f32 at batch 2 on the card and on the CPU, the same
    weights and priorities: the same keys, every covariance within 1e-4 of
    its largest entry (f32 sums of the same patch products in other
    orders; the RoIs of the bbox head's taps are sampled from each
    device's own proposals, which agree here); the loss forward launches
    the assign, NMS and RoIAlign kernels once and no RPN head kernel (the
    taps run the head unfused)."""
    from nsgp_repre_tpu_torch.engine.train import make_cov_step
    from nsgp_repre_tpu_torch.models.detector import FasterRCNN
    from nsgp_repre_tpu_torch.testing import demo_det_batch, tiny_detector_config

    cfg = tiny_detector_config(rpn_num=64, rcnn_num=32)
    cpu = FasterRCNN(cfg).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.rpn_head.rpn_cls.weight.mul_(20.0)
    card = FasterRCNN(cfg)
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    batch = demo_det_batch(2, 64, 96, num_instances=(2, 3), num_classes=2, gt_capacity=4, seed=1)
    n = sum(-(-64 // s) * -(-96 // s) * cfg.num_base_priors for s in cfg.anchor_strides)
    pg = torch.Generator().manual_seed(5)
    pri = {"rpn": torch.rand(2, n, generator=pg), "roi": torch.rand(2, 4 + cfg.rpn_max_per_img,
                                                                    generator=pg)}
    pri["roi2"] = torch.rand(pri["roi"].shape, generator=pg)
    _ext.reset_launches()
    got = make_cov_step(card)(batch.to(dev), priorities=pri)
    torch.cuda.synchronize()
    assert dict(_ext.LAUNCHES) == {"conv3x3": 0, "rpn_head": 0, "nms": 1, "roi_align": 1,
                                   "roi_align_bwd": 0, "assign": 1, "gather": 0}
    ref = make_cov_step(cpu)(batch, priorities=pri)
    assert got.keys() == ref.keys() and "rpn_head/rpn_conv/kernel" in ref
    for k, r in ref.items():
        scale = r.abs().max().item()
        assert (got[k].cpu() - r).abs().max().item() <= 1e-4 * scale, k


def test_small_runner_epoch_on_card(dev, tmp_path):
    """A SMALL task-1 NullSpaceRunner on the card, on tests/voc_fixture.py's
    8 images (4 in task 1, batch 2): its first step's loss terms match a
    CPU runner's on the same batch and the same draws within 1e-3 relative
    (acc within 2/rcnn_num; chip_smoke.py's train-phase rule), then its
    epoch, validation and task-end passes launch the kernels the batches
    account for, and its files load into a fresh model and the readers."""
    from nsgp_repre_tpu_torch.engine.runner import NullSpaceRunner
    from nsgp_repre_tpu_torch.models.detector import FasterRCNN
    from nsgp_repre_tpu_torch.utils import checkpoint as ckpt_io
    from nsgp_repre_tpu_torch.utils.config import Config
    from voc_fixture import make_cfg, make_voc

    voc = make_voc(tmp_path / "VOCdevkit")
    runners = {d: NullSpaceRunner(Config.wrap(make_cfg(voc, str(tmp_path / d), 1)), device=d)
               for d in ("cpu", "cuda")}
    cfg = runners["cpu"].model.config
    n = sum(-(-64 // s) * -(-128 // s) * cfg.num_base_priors for s in cfg.anchor_strides)
    pg = torch.Generator().manual_seed(0)
    pri = {"rpn": torch.rand(2, n, generator=pg),
           "roi": torch.rand(2, runners["cpu"].gt_capacity + cfg.rpn_max_per_img, generator=pg)}
    pri["roi2"] = torch.rand(pri["roi"].shape, generator=pg)
    terms, firsts = {}, {}
    for d, r in runners.items():
        batch, meta = next(iter(r.train_loader))
        assert batch.images.device.type == d
        firsts[d] = (list(meta), batch.images.cpu())
        _, metrics = r.train_step(r.state, batch, priorities={k: v.to(d) for k, v in pri.items()})
        terms[d] = {k: float(v) for k, v in metrics.items()}
    assert firsts["cpu"][0] == firsts["cuda"][0] and torch.equal(firsts["cpu"][1], firsts["cuda"][1])
    for k, ref in terms["cpu"].items():
        lim = 2.0 / cfg.rcnn_num if k == "acc" else 1e-3 * max(abs(ref), 1e-3)
        assert abs(terms["cuda"][k] - ref) <= lim, (k, terms["cuda"][k], ref)

    card = runners["cuda"]
    _ext.reset_launches()
    card.train()
    torch.cuda.synchronize()
    t = card.timings
    assert (t["train_steps"], t["val_images"], t["importance_batches"], t["cov_batches"],
            t["roi_batches"]) == (2, 8, 2, 2, 2)
    step = {"rpn_head": 5, "nms": 1, "roi_align": 1, "roi_align_bwd": 1, "assign": 1}
    per = {  # (calls, launches per call): steps and importance, val, cov, RoI store
        "steps": (4, step), "val": (4, {"nms": 2, "roi_align": 1}),
        "cov": (2, {"nms": 1, "roi_align": 1, "assign": 1}), "rois": (2, {"nms": 1, "roi_align": 1})}
    want = {k: sum(c * p.get(k, 0) for c, p in per.values()) for k in _ext.LAUNCHES}
    assert dict(_ext.LAUNCHES) == want
    fresh = FasterRCNN(cfg)
    ckpt_io.load_checkpoint(fresh, ckpt_io.find_checkpoint(card.work_dir, "best"), strict=True)
    assert all(torch.equal(v, card.model.state_dict()[k].cpu()) for k, v in fresh.state_dict().items())
    assert ckpt_io.load_covariance(card.work_dir) and len(ckpt_io.load_rois_etc(card.work_dir)[0]) == 10
    assert len(ckpt_io.load_ewc_terms(card.work_dir, 2)) == 34
