"""Box pairs whose IoU lies exactly on an NMS threshold, or one ulp on
either side of it, for the NMS kernel's tests on the CPU
(tests/test_torch_nms.py) and on the card (tests/test_torch_cuda.py).
numpy only, so the card tests can import it on a host without JAX.
"""
import numpy as np

F = np.float32


def iou_f32(a, b):
    """The plain version's IoU in f32 (ops/nms.py::pairwise_iou, a the
    earlier box), with the rounded quotient."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    iw = np.maximum(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), F(0))
    ih = np.maximum(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), F(0))
    inter = iw * ih
    return inter / np.maximum(area_a + area_b - inter, F(1e-6))


def edge_pairs(thr, n_each, seed=0, x0=0.0):
    """Nested box pairs (b inside a, both with corner (x0, 0)) whose f32
    IoU is exactly thr, one ulp above it or one ulp below it:
    {kind: (a, b)}, each (n_each, 4) f32."""
    rng = np.random.RandomState(seed)
    thr = F(thr)
    targets = {"at": thr, "above": np.nextafter(thr, F(1)), "below": np.nextafter(thr, F(0))}
    w = rng.uniform(10, 100, 4000).astype(F)
    h = rng.uniform(10, 100, 4000).astype(F)
    h2 = np.nextafter(h * thr, F(0))
    found = {k: [] for k in targets}
    zero, left = np.zeros_like(w), np.full_like(w, F(x0))
    for _ in range(5):  # h2 from one ulp under h * thr to three over it
        a = np.stack([left, zero, left + w, h], -1)
        b = np.stack([left, zero, left + w, h2], -1)
        iou = iou_f32(a, b)
        for k, t in targets.items():
            sel = iou == t
            found[k] += list(zip(a[sel], b[sel]))
        h2 = np.nextafter(h2, F(1000))
    out = {}
    for k, pairs in found.items():
        assert len(pairs) >= n_each, (k, len(pairs))
        out[k] = (np.stack([p[0] for p in pairs[:n_each]]), np.stack([p[1] for p in pairs[:n_each]]))
    return out
