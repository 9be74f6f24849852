"""The share of its roofline of the int8 detector's conv, csrc/cuda_int8.cu
(the s8 implicit GEMM with the requant in its epilogue, 19 launches a
forward): the least time the traced ticks' convs could take (bytes at the
HBM rate or operations at the int8 peak, whichever is larger) over the
kernel's device time."""

from benchmark.readers import int8_conv, roofline


def read(rec):
    return roofline(rec, "int8_conv_roofline", ("gv_int8_conv_kernel",), (),
                    int8_conv, peak="int8_ops_per_s")
