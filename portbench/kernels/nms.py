"""Batched greedy NMS (csrc/nms.cu).

Work: each image's candidate boxes and scores read once, the kept indices
and the count written once. The IoUs a walk needs depend on the data;
none are counted, so the least time is the bytes' alone (a lower bound)."""

NAMES = ("nms_walk",)
DTYPE = "float32"


def work(B: int, N: int, max_out: int):
    return B * (N * 16 + N * 4 + 4 + max_out * 4 + 4), 0, DTYPE
