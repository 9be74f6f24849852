"""The share of its roofline of the CSP stage (ConvBN_2 + CSPBlock_0 + the
pool), csrc/cuda_csp.cu: the least time the traced ticks' work could take
(bytes at the HBM rate or operations at the configuration's peak, whichever
is larger) over the kernel's device time."""

from benchmark.readers import csp, roofline


def read(rec):
    return roofline(rec, "csp_f32_roofline", ("gv_csp_",), ("bf16",),
                    csp)
