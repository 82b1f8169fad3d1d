"""FPN multilevel RoIAlign forward (csrc/roi_align.cu).

Work: the outputs written once, the RoIs and their image indices read once
(the feature rows the taps touch depend on the boxes and are not counted:
a lower bound); per output element 4 samples of 4 bilinear taps (a
multiply-add each) and the mean."""

NAMES = ("roi_align_kernel",)
DTYPE = "float32"


def work(R: int, C: int, out: int, ss: int, size: int = 2):
    bins = R * out * out
    nbytes = bins * C * size + R * 16 + R * 4
    flops = bins * ss * ss * (4 * 2 + 1) * C + bins * C
    return nbytes, flops, DTYPE
