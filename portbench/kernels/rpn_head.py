"""The fused RPN head: a 3x3 conv C -> F with bias and ReLU, then the packed
1x1 to P = 5A outputs, one launch per level (csrc/conv3x3.cu).

Work: every input read once, every output written once, the weights once
per launch; 2 FLOPs per multiply-add of both convs."""

NAMES = ("conv3x3_wgmma", "conv3x3_simt", "rpn_head_reduce")
DTYPE = "bfloat16"


def work(B: int, H: int, W: int, C: int, F: int, P: int, size: int = 2):
    px = B * H * W
    nbytes = px * C * size + px * P * size + 9 * C * F * size + F * 4 + F * P * size + P * 4
    flops = 2 * px * (9 * C * F + F * P)
    return nbytes, flops, DTYPE
