"""The yardstick's table of peaks and the least work of the scoring
kernel, counted from a request's shapes at element sizes the problem
fixes, whatever implements the scoring.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at its full
700 W limit: 3.35 TB/s of HBM, 67 TFLOP/s of float32 outside the tensor
cores.
"""

from __future__ import annotations

PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_ops_per_s": 67e12}

# the scores of one candidate: weighted hops, total hops, data and
# latency maxima, their arguments and a status word, 8 B each
SCORE_VALUES = 8


def scoring_work(*, candidates: int, tasks: int, edges: int,
                 dims: tuple, network_dims: int, traffic: bool) -> dict:
    """Bytes and operations the scoring of one candidate stack needs.

    Bytes: the coordinate stack (every task's machine coordinates under
    each candidate: the network dims, and with traffic every dim, since
    the links a message loads are keyed by them), the messages' two
    endpoints and volume, with traffic one inverse bandwidth per link
    position along each network dim, and the scores, each read or
    written once at 4 B a coordinate, endpoint, volume and inverse
    bandwidth and 8 B a score.
    Operations: per message, candidate and network dim the hop
    arithmetic (difference, absolute value, wrap, add: 4), and with
    traffic per (message, candidate, dim) a direction test and two
    difference-array adds (3), plus a running sum and two compares per
    link-load entry (3).
    """
    cols = len(dims) if traffic else network_dims
    nbytes = (candidates * tasks * cols * 4 + edges * 2 * 4 + edges * 4
              + candidates * SCORE_VALUES * 8)
    ops = candidates * edges * network_dims * 4
    if traffic:
        nbytes += sum(dims[:network_dims]) * 4
        links = 2 * network_dims
        for d in dims:
            links *= d
        ops += candidates * edges * network_dims * 3 + candidates * links * 3
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    t_ops = ops / PEAKS["fp32_ops_per_s"]
    return {"bytes": nbytes, "ops": ops, "least_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
