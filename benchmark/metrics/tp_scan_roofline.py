"""tp_scan_roofline: The time-parallel phase path's DF-II scans against their roofline, in percent:
a chunk's least bytes of the scans (harness/time_parallel.py::scan_bytes, (3T + 10) h w 4 B a
band level and component) over the memory peak, over the device time of its ``phase_tp.scan``
spans (CUDA events), median over the window's chunks outside the profiled one. None where the
program has no such span."""

from benchmark.harness import spans, time_parallel

spans.install()


def read(ctx):
    return time_parallel.scan_roofline(ctx)
