"""Device time a tick of the cuDNN and cuBLAS conv and GEMM kernels in the
traced segment, matched by name, the port's own gv_ kernels left out: the
library kernels of every layer (the detector's convs after the stem and
CSP kernels, the orientation net's, any matmul). The names do not say
which layer launched a kernel."""

from benchmark.readers import LIBRARY_WORDS, kernel_s


def read(rec):
    t = kernel_s(rec, LIBRARY_WORDS, ("gv_",))
    return None if t is None else t / rec.work["ticks"] * 1e3
