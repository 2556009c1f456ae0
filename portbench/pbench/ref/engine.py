"""The plain reference of a flat mapping request (paper Alg. 1 + §4.3).

Everything the program derives from a job's arrays is worked out again
here in numpy: the machine-side transforms (core dims dropped, torus
shift), the rotation candidates, both sides' Multi-Jagged part numbers
(:mod:`pbench.ref.orderings`), part matching, the WeightedHops and
Latency(M) scores under dimension-ordered routing, and the first-of-ties
winner.  A job with more tasks than cores is cut into one part a core
on both sides, as Algorithm 1 does, and several tasks then share a core.
It imports nothing of the program; its inputs are the job's plain arrays
(:class:`pbench.gen.Job`).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from .orderings import order_points_batched

OBJECTIVES = {"wh": ("weighted_hops",),
              "latency": ("latency_max", "weighted_hops")}


@dataclasses.dataclass(frozen=True)
class Machine:
    """A torus of routers with a trailing core dim of free links."""

    dims: tuple          # router dims + (cores per router,)
    wrap: tuple          # per dim; the core dim never wraps
    link_bw: tuple       # per network dim: bandwidth pattern along it
    core_dims: int = 1

    @property
    def nd(self) -> int:
        return len(self.dims) - self.core_dims

    def bw_field(self, k: int) -> np.ndarray:
        """Bandwidth of the + link of every coordinate along dim ``k``."""
        pat = np.asarray(self.link_bw[k], dtype=np.float64)
        bw = pat[np.arange(self.dims[k]) % len(pat)]
        shape = [1] * len(self.dims)
        shape[k] = self.dims[k]
        return np.broadcast_to(bw.reshape(shape), self.dims)


def shift_torus(coords: np.ndarray, machine: Machine) -> np.ndarray:
    """Rotate each wrapped dim so its largest gap of unoccupied
    coordinates sits at the boundary (paper §4.3)."""
    coords = np.asarray(coords, dtype=np.float64).copy()
    for k in range(machine.nd):
        if not machine.wrap[k]:
            continue
        s = machine.dims[k]
        occ = np.unique(coords[:, k].astype(np.int64))
        if len(occ) <= 1:
            continue
        gaps = np.diff(np.concatenate([occ, occ[:1] + s]))
        g = int(np.argmax(gaps))
        if gaps[g] <= 1:
            continue
        origin = (occ[g] + gaps[g]) % s
        coords[:, k] = (coords[:, k] - origin) % s
    return coords


def rotation_candidates(td: int, pd: int, rotations: int) -> list:
    """(task_perm, proc_perm) pairs: the smallest balanced grid of evenly
    spaced permutations of each side that covers ``rotations``; the
    identity pair first."""
    if not rotations:
        return [(tuple(range(td)), tuple(range(pd)))]
    ta = list(itertools.permutations(range(td)))
    pa = list(itertools.permutations(range(pd)))
    if len(ta) * len(pa) <= rotations:
        return [(a, b) for a in ta for b in pa]
    best = None
    for na in range(1, len(ta) + 1):
        nb = min(-(-rotations // na), len(pa))
        if na * nb < rotations:
            continue
        key = (na + nb, abs(na - nb))
        if best is None or key < best[0]:
            best = (key, na, nb)
    _, na, nb = best
    sa = [ta[i] for i in np.linspace(0, len(ta) - 1, na).astype(int)]
    sb = [pa[i] for i in np.linspace(0, len(pa) - 1, nb).astype(int)]
    return [(a, b) for a in sa for b in sb][:rotations]


def _unique_rows(perms) -> tuple[np.ndarray, np.ndarray]:
    uniq = sorted(set(perms))
    of = {p: i for i, p in enumerate(uniq)}
    return (np.array(uniq, dtype=np.int64),
            np.array([of[p] for p in perms], dtype=np.int64))


def sweep_assignments(tc, pc, cands, *, sfc="FZ", task_weights=None):
    """Every candidate's task -> processor index, (ncand, ntasks).  Both
    sides are cut into ``pnum`` parts, one processor a part: a part of
    the tasks holds one task, or several where there are more tasks
    than processors."""
    (tnum, td), (pnum, pd) = tc.shape, pc.shape
    if tnum < pnum:
        raise ValueError("the reference maps no fewer tasks than cores: "
                         f"{tnum} tasks, {pnum} cores")
    ut, t_sel = _unique_rows([c[0] for c in cands])
    up, p_sel = _unique_rows([c[1] for c in cands])
    kw = dict(longest_dim=True, uneven_prime=False)
    mu_t = order_points_batched(tc, pnum, sfc, dim_orders=ut,
                                weights=task_weights, **kw)
    mu_p = order_points_batched(pc, pnum, sfc, dim_orders=up, **kw)
    part_to_proc = np.full(mu_p.shape, -1, dtype=np.int64)
    rows = np.arange(len(mu_p))[:, None]
    part_to_proc[rows, mu_p] = np.arange(pnum)[None, :]
    if (part_to_proc < 0).any():
        raise ValueError("a part holds no processor")
    return np.take_along_axis(part_to_proc[p_sel], mu_t[t_sel], axis=1)


def hops(machine: Machine, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    total = np.zeros(src.shape[:-1], dtype=np.int64)
    for k in range(machine.nd):
        s = machine.dims[k]
        d = np.abs(src[..., k] - dst[..., k])
        if machine.wrap[k]:
            d = np.minimum(d, s - d)
        total += d
    return total


def link_loads(machine: Machine, src: np.ndarray, dst: np.ndarray,
               w: np.ndarray) -> list:
    """Per network dim, the (+ load, - load) arrays of the machine's
    shape under dimension-ordered routing (dim 0 first, shortest way
    round a torus, ties forward).  Each message adds its volume to a run
    of links along the dim, which a difference array sums: a run that
    wraps spills past column ``s`` and is folded back."""
    out = []
    cur = np.asarray(src, dtype=np.int64).copy()
    dst = np.asarray(dst, dtype=np.int64)
    dims = machine.dims
    for k in range(machine.nd):
        s = dims[k]
        a, b = cur[:, k], dst[:, k]
        if machine.wrap[k]:
            fwd, bwd = (b - a) % s, (a - b) % s
            use_fwd = fwd <= bwd
            len_f = np.where(use_fwd, fwd, 0)
            len_b = np.where(use_fwd, 0, bwd)
        else:
            use_fwd = b >= a
            len_f = np.where(use_fwd, b - a, 0)
            len_b = np.where(use_fwd, 0, a - b)
        other = [cur[:, j] for j in range(len(dims)) if j != k]
        row_dims = tuple(d for j, d in enumerate(dims) if j != k)
        row = np.ravel_multi_index(other, row_dims)
        nrows = int(np.prod(row_dims))
        loads = []
        for start, length in ((a, len_f), ((a - len_b) % s, len_b)):
            m = length > 0
            key = row[m] * (2 * s + 1) + start[m] % s
            diff = np.bincount(
                np.concatenate([key, key + length[m]]),
                weights=np.concatenate([w[m], -w[m]]),
                minlength=nrows * (2 * s + 1)).reshape(nrows, 2 * s + 1)
            lane = np.cumsum(diff[:, :2 * s], axis=1)
            lane = lane[:, :s] + lane[:, s:]      # fold the wrapped part
            lane = lane.reshape(row_dims + (s,))
            loads.append(np.moveaxis(lane, -1, k))
        out.append(tuple(loads))
        cur[:, k] = b
    return out


def score(machine: Machine, alloc: np.ndarray, edges: np.ndarray,
          w: np.ndarray, t2p: np.ndarray, traffic: bool) -> dict:
    """The scores of one assignment, from the allocation's raw
    coordinates (transforms only steer the partitioner)."""
    c = alloc[t2p]
    src, dst = c[edges[:, 0]], c[edges[:, 1]]
    out = {"weighted_hops": float((hops(machine, src, dst) * w).sum())}
    if traffic:
        lat = 0.0
        for k, loads in enumerate(link_loads(machine, src, dst, w)):
            bw = machine.bw_field(k)
            for arr in loads:
                lat = max(lat, float((arr / bw).max()))
        out["latency_max"] = lat
    return out


def first_best(rows: list) -> int:
    """Index of the lexicographically least score row; ties keep the
    first."""
    best = 0
    for i, r in enumerate(rows):
        if r < rows[best]:
            best = i
    return best


def map_flat(job, *, sfc="FZ", shift=True, rotations=8,
             objective="wh", task_weights=None) -> dict:
    """The answer a flat request has to get: ``task_to_proc``, the
    winner's ``rotation`` ((task_perm, proc_perm)) and its ``score``
    (the objective's first key); ``task_weights`` weigh the task side's
    cuts."""
    m = job.machine
    pc = np.asarray(job.alloc[:, :m.nd], dtype=np.float64)
    if shift:
        pc = shift_torus(pc, m)
    tc = np.asarray(job.task_coords, dtype=np.float64)
    cands = rotation_candidates(tc.shape[1], pc.shape[1], rotations)
    t2p = sweep_assignments(tc, pc, cands, sfc=sfc,
                            task_weights=task_weights)
    keys = OBJECTIVES[objective]
    traffic = "latency_max" in keys
    rows = []
    for row in t2p:
        ev = score(m, job.alloc, job.edges, job.weights, row, traffic)
        rows.append(tuple(ev[k] for k in keys))
    i = first_best(rows)
    return {"task_to_proc": t2p[i].astype(np.int64),
            "rotation": cands[i], "score": rows[i][0]}
