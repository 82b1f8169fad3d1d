"""RoIAlign's gradient into the level maps (csrc/roi_align.cu: binning,
tile order and the per-tile sums).

Work: the output gradient and the RoIs read once, every level map's
gradient written once; per output element 4 samples of 4 taps (a
multiply-add each)."""

NAMES = ("roi_bin_kernel", "roi_tile_order_kernel", "roi_footprint_kernel", "roi_align_bwd_kernel")
DTYPE = "float32"


def work(R: int, C: int, out: int, ss: int, map_elems: int, size: int = 2):
    bins = R * out * out
    nbytes = bins * C * size + R * 20 + map_elems * size
    flops = bins * ss * ss * 4 * 2 * C
    return nbytes, flops, DTYPE
