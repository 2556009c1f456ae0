"""Allocation kind ``hilbert-sfc``: ALPS-style sparse allocations, a
Hilbert-curve order of the routers cut into ``fragments`` runs placed at
random free offsets, as other jobs hold the rest of the machine."""

import numpy as np

from pbench.ref.engine import Machine
from pbench.ref.orderings import hilbert_index


def build(spec: dict, machine: Machine) -> "HilbertSparse":
    return HilbertSparse(machine, spec)


class HilbertSparse:
    """Sparse allocations of ``tasks`` cores, one router's cores whole
    (the last router's trimmed), in ``fragments`` runs of the routers'
    Hilbert order placed at random free offsets."""

    def __init__(self, machine: Machine, spec: dict):
        self.spec = spec
        rdims = machine.dims[:machine.nd]
        self.routers = np.stack(
            [g.ravel() for g in np.indices(rdims)], axis=1)
        bits = max(1, int(np.ceil(np.log2(max(max(rdims), 2)))))
        self.order = np.argsort(hilbert_index(self.routers, bits),
                                kind="stable")
        cores = machine.dims[machine.nd]
        self.cores = np.arange(cores)
        self.nrouters = -(-int(spec["tasks"]) // cores)

    def draw(self, rng: np.random.Generator) -> np.ndarray:
        total, nr = len(self.order), self.nrouters
        nf = int(self.spec["fragments"])
        sizes = np.full(nf, nr // nf)
        sizes[:nr % nf] += 1
        occupied = np.zeros(total, dtype=bool)
        segs = []
        for sz in sizes:
            for _ in range(256):
                s = int(rng.integers(0, total - sz + 1))
                if not occupied[s:s + sz].any():
                    break
            else:
                raise ValueError("no free run for a fragment")
            occupied[s:s + sz] = True
            segs.append(self.order[s:s + sz])
        chosen = self.routers[np.concatenate(segs)]
        k = len(self.cores)
        coords = np.concatenate([np.repeat(chosen, k, axis=0),
                                 np.tile(self.cores, len(chosen))[:, None]],
                                axis=1)[:int(self.spec["tasks"])]
        box = self.spec.get("rank_box")
        if box is not None:
            # the system's default rank order: whole boxes of routers
            # before the slow links between them
            b = np.asarray(box)
            outer, inner = coords[:, :3] // b, coords[:, :3] % b
            coords = coords[np.lexsort((
                coords[:, 3], inner[:, 2], inner[:, 1], inner[:, 0],
                outer[:, 2], outer[:, 1], outer[:, 0]))]
        return coords.astype(np.int64)
