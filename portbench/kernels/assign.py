"""The fused RPN anchor assignment and regression targets (csrc/assign.cu).

Work: the anchors, the gt slots and the anchors' valid flags read once,
the assignment, the best IoU and the targets written once; one IoU (13
FLOPs) per anchor and valid gt box, counting the image's real gt boxes
only (a lower bound: the teacher's merged boxes are left out), plus the
target encoding."""

NAMES = ("gt_max_kernel", "assign_kernel")
DTYPE = "float32"
IOU_FLOPS = 13


def work(B: int, N: int, G: int, V: int):
    nbytes = N * 16 + B * G * 17 + B * N + B * N * (4 + 4 + 16)
    flops = V * N * (2 * IOU_FLOPS + 3) + B * N * 16
    return nbytes, flops, DTYPE
