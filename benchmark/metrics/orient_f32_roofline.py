"""The share of its roofline of the orientation front (crop, standardize, the
folded stem conv), csrc/cuda_orient.cu: the least time the traced ticks'
work could take (bytes at the HBM rate or operations at the TF32 peak, the
rate of its 3xTF32 products, whichever is larger) over the kernel's device
time."""

from benchmark.readers import orient, roofline


def read(rec):
    return roofline(rec, "orient_f32_roofline", ("gv_orient_",), ("bf16",),
                    orient, peak="tf32_flops_per_s")
