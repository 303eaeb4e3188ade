"""csr.kernels_roofline: a build's bound over the device's busy time a build
in the traced window. The bound, whatever implements the build: the three
u32 inputs (src, dst, weight) of each edge read once and the CSR's columns
and weights written once, 20 bytes an edge, and the int32 row starts
written once, 4 bytes a vertex, over the peak bandwidth."""

from benchmark import roofline

EDGE_BYTES = 20
VERTEX_BYTES = 4


def read(run):
    trace = run.traces[0]
    if not trace.device_ops:
        return None
    edges = run.work_per_step
    vertices = edges // run.traffic["edges"]["edgefactor"]
    per_build_s = trace.busy_us / 1e6 / len(trace.calls_us)
    return 100.0 * roofline.bound_s(EDGE_BYTES * edges + VERTEX_BYTES * vertices) / per_build_s
