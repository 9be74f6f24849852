"""The share of its roofline of the fused stem (resize + ConvBN_0 + ConvBN_1),
csrc/cuda_stem_bf16.cu: the least time the traced ticks' work could take
(bytes at the HBM rate or operations at the configuration's peak, whichever
is larger) over the kernel's device time."""

from benchmark.readers import stem, roofline


def read(rec):
    return roofline(rec, "stem_bf16_roofline", ("gv_stem_bf16_kernel",), (),
                    stem)
