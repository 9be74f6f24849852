"""The share of its roofline of the orientation front (crop, standardize, the
folded stem conv), csrc/cuda_orient_bf16.cu: the least time the traced
ticks' work could take (bytes at the HBM rate or operations at the
configuration's peak, whichever is larger) over the kernel's device time."""

from benchmark.readers import orient, roofline


def read(rec):
    return roofline(rec, "orient_bf16_roofline", ("gv_orient_bf16_kernel",),
                    (), orient)
