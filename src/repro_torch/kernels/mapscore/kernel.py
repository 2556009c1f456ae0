"""ctypes binding of ``csrc/mapscore.cu``: parameter struct, workspace and
scratch layout, status word and the launch call.

The CUDA source replaces the Pallas kernel of the reference package
(``src/repro/kernels/mapscore/kernel.py``); see the note at its top for
what bounds it and what the design does about that.  This module only
describes the buffers and calls ``mapscore_launch``; it is imported
freely on machines without a GPU — the library is built and loaded at
the first launch.
"""

from __future__ import annotations

import ctypes
import math

from repro_torch.kernels import _build

MAX_DIMS = 8
GROUP_MAX = 8          # candidates one group of the kernel may hold
PREP_CHUNK = 2048      # messages (or coordinate rows) per block of the
                       # kernel's first pass
# the design, as the kernels line of chip_smoke.py reports it
DESIGN = "packed-pipeline"

PIPELINE_GROUPS = 4        # groups the candidates split into, at least

# status word: what the kernel found wrong with its inputs
ST_EDGE = 1            # an edge index outside [0, ntasks)
ST_COL0 = 2            # << j: a coordinate of column j leaves [0, d)
ST_WEIGHT = 1 << 9     # the |w| sum is not finite
SHIFT_NONE = -2000     # the shift reported when the |w| sum is not finite

# scratch: header entries, then SLOTS per candidate, then the workspace
HEADER = 4
SLOTS = 4


class MapscoreParams(ctypes.Structure):
    """Mirror of ``struct MapscoreParams`` in ``csrc/mapscore.cu``."""

    _fields_ = [
        ("ndim", ctypes.c_int32),
        ("nd", ctypes.c_int32),
        ("ncols", ctypes.c_int32),
        ("traffic", ctypes.c_int32),
        ("group", ctypes.c_int32),
        ("packed64", ctypes.c_int32),
        ("nb", ctypes.c_int64),
        ("ntasks", ctypes.c_int64),
        ("ne", ctypes.c_int64),
        ("unit", ctypes.c_int64),
        ("rows_max", ctypes.c_int64),
        ("cand_off", ctypes.c_int64),
        ("ws_off", ctypes.c_int64),
        ("prep_blocks", ctypes.c_int64),
        ("span", ctypes.c_double),
        ("dims", ctypes.c_int32 * MAX_DIMS),
        ("wrap", ctypes.c_int32 * MAX_DIMS),
        ("rows", ctypes.c_int32 * MAX_DIMS),
        ("bw_off", ctypes.c_int32 * MAX_DIMS),
        ("pshift", ctypes.c_int32 * MAX_DIMS),
        ("pmask", ctypes.c_uint32 * MAX_DIMS),
        ("stride", (ctypes.c_int32 * MAX_DIMS) * MAX_DIMS),
    ]


def workspace_layout(dims, core_dims: int):
    """Link-accumulator layout of ONE candidate.

    Per network dim ``k`` two int64 arrays (+ then - direction) of shape
    ``(s_k, rows_k)``, rows contiguous, ``rows_k`` the product of the
    other machine dims: one unit of ``2 * prod(dims)`` entries per dim.
    Returns ``(rows, acc_off, entries)``: per-dim row counts, per-dim
    start offsets and the total entry count.
    """
    nd = len(dims) - core_dims
    rows, acc_off, off = [], [], 0
    for k in range(nd):
        r = 1
        for j, d in enumerate(dims):
            if j != k:
                r *= int(d)
        rows.append(r)
        acc_off.append(off)
        off += 2 * int(dims[k]) * r
    return rows, acc_off, off


def group_size(per_cand: int, nb: int, budget: int) -> int:
    """Candidates per group of the kernel's pipeline: at most ``budget``
    link-accumulator entries and :data:`GROUP_MAX` candidates a group,
    and at least :data:`PIPELINE_GROUPS` groups where there are enough
    candidates, so that most groups reduce beside the next one's
    accumulate (``per_cand`` 0, hop sums only: :data:`GROUP_MAX`)."""
    if not per_cand:  # hop sums only: no workspace, no pipeline
        return GROUP_MAX
    return int(max(1, min(GROUP_MAX, budget // per_cand,
                          -(-nb // PIPELINE_GROUPS))))


def candidate_groups(nb: int, per_group: int) -> list[range]:
    """The kernel's groups of candidates, in launch order: ``per_group``
    (capped at :data:`GROUP_MAX`) at a time."""
    g = max(1, min(per_group, GROUP_MAX))
    return [range(c0, min(c0 + g, nb)) for c0 in range(0, nb, g)]


def scratch_entries(nb: int, ws_entries: int) -> tuple:
    """``(cand_off, ws_off, total)`` int64 entries of the persistent
    scratch: header, per-candidate slots, then two workspaces of
    ``ws_entries`` each, one group's (aligned to 32 entries)."""
    cand_off = HEADER
    ws_off = -(-(cand_off + SLOTS * nb) // 32) * 32
    return cand_off, ws_off, ws_off + 2 * ws_entries


def packing(dims, ncols: int) -> tuple[list[int], list[int], bool]:
    """``(shift, mask, wide)`` of the packed coordinate word: column ``j``
    at bits ``[shift[j], shift[j] + bits_j)``; ``wide`` when the word
    needs 64 bits."""
    shift, mask, at = [], [], 0
    for d in dims[:ncols]:
        bits = (int(d) - 1).bit_length()
        shift.append(at)
        mask.append((1 << bits) - 1)
        at += bits
    return shift, mask, at > 32


def row_strides(dims, core_dims: int) -> list[list[int]]:
    """Per network dim ``k``, the weight of each machine dim's coordinate
    in the row key: mixed radix over the other dims in order, 0 for dim
    ``k`` itself (the key :func:`workspace_layout` rows run over)."""
    nd = len(dims) - core_dims
    out = []
    for k in range(nd):
        st, r = [0] * len(dims), 1
        for j in reversed(range(len(dims))):
            if j != k:
                st[j] = r
                r *= int(dims[j])
        out.append(st)
    return out


def prep_blocks(ne: int, nrows: int) -> int:
    """Blocks of the kernel's first pass: one per PREP_CHUNK messages or
    coordinate rows, whichever needs more (at most 65535)."""
    return int(min(65535, max(1, -(-max(ne, nrows) // PREP_CHUNK))))


def hop_span(dims, core_dims: int) -> int:
    """Most hops any message can take: the sum of the network extents
    (at least 2)."""
    return max(2, sum(int(d) for d in dims[:len(dims) - core_dims]))


def fixed_point_shift(abs_weight_sum: float, dims, core_dims: int) -> int:
    """Exponent ``e`` of the power-of-two fixed-point scale ``2**e``.

    Chosen so that neither the weighted hop sum (every message at the
    machine's largest hop count) nor any link load or difference-array
    entry can reach 2**62: 64-bit integer sums then cannot overflow in
    whatever order the atomics land.  The kernel computes the same
    exponent on the card from its own fixed-order sum of |w|.
    """
    bound = float(abs_weight_sum) * hop_span(dims, core_dims)
    if not math.isfinite(bound):
        raise ValueError("message weights must be finite")
    if bound <= 0.0:
        return 0
    _, exp = math.frexp(bound)  # bound < 2**exp
    return 62 - exp


def status_error(code: int, dims) -> str | None:
    """The message of the first fault a status word reports, in the
    order the inputs are checked; None when it is all clear."""
    code = int(code)
    if code & ST_EDGE:
        return "edges index outside the task range"
    for j, d in enumerate(dims):
        if code & (ST_COL0 << j):
            return f"coord_stack column {j} leaves [0, {int(d)})"
    if code & ST_WEIGHT:
        return "message weights must be finite"
    return None


_LAUNCH = None


def _launch_fn():
    """``mapscore_launch`` of the built library, argtypes set."""
    global _LAUNCH
    if _LAUNCH is None:
        lib = _build.load_library()
        for name, want in (("mapscore_params_size",
                            ctypes.sizeof(MapscoreParams)),
                           ("mapscore_group_max", GROUP_MAX)):
            getattr(lib, name).restype = ctypes.c_int
            got = getattr(lib, name)()
            if got != want:
                raise RuntimeError(f"{name}: kernel.py says {want}, "
                                   f"mapscore.cu {got}")
        lib.mapscore_error_string.restype = ctypes.c_char_p
        lib.mapscore_error_string.argtypes = [ctypes.c_int]
        fn = lib.mapscore_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.POINTER(MapscoreParams), ctypes.c_void_p]
        _LAUNCH = (fn, lib.mapscore_error_string)
    return _LAUNCH


def mapscore_launch(coords: int, edges: int, w: int, inv_bw: int | None,
                    e32: int, table: int, parts: int, scratch: int,
                    res: int, params: MapscoreParams, stream: int) -> None:
    """Enqueue the kernel's passes on ``stream``; every buffer is a
    device address (see ``mapscore_launch`` in the source).  Raises when
    a launch is refused; does not synchronise."""
    fn, errstr = _launch_fn()
    code = fn(coords, edges, w, inv_bw, e32, table, parts, scratch, res,
              ctypes.byref(params), stream)
    if code != 0:
        raise RuntimeError(
            f"mapscore launch failed: CUDA error {code} "
            f"({errstr(code).decode()})")
