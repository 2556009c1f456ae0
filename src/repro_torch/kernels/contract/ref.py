"""Plain-torch version of the contract kernels, and what both share: the
packed result (:class:`Contraction`).

It follows the kernels' design with whole-array torch operations: the
same pair keys and sentinel, the same stable sorts, heads and integer
scan; the in-order sums are ``torch.bincount`` with float64 weights,
which on the CPU adds each bin's weights in index order, as
``np.bincount`` does.  On a CUDA device ``torch.bincount`` adds with
atomics, in an order that changes from run to run, so the plain version
takes CPU tensors only.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Contraction:
    """A contraction in one packed int64 tensor (float64 values as their
    bit patterns), so that one copy moves it: sizes (nc), weights (nc),
    centroids (nc x d), pairs (m x 2), volumes (m), intra volumes (k)."""

    packed: torch.Tensor
    nclusters: int
    d: int
    npairs: int
    nintra: int

    def _part(self, start: int, length: int) -> torch.Tensor:
        return self.packed[start:start + length]

    @property
    def _pairs_at(self) -> int:
        return self.nclusters * (2 + self.d)

    @property
    def sizes(self) -> torch.Tensor:
        """(nc,) int64 tasks a cluster."""
        return self._part(0, self.nclusters)

    @property
    def weights(self) -> torch.Tensor:
        """(nc,) float64 summed task weight a cluster."""
        return self._part(self.nclusters, self.nclusters).view(torch.float64)

    @property
    def centroids(self) -> torch.Tensor:
        """(nc, d) float64 weighted centroids."""
        nc, d = self.nclusters, self.d
        return self._part(2 * nc, nc * d).view(torch.float64).view(nc, d)

    @property
    def edges(self) -> torch.Tensor:
        """(m, 2) int64 inter-cluster pairs in key order."""
        return self._part(self._pairs_at, 2 * self.npairs).view(-1, 2)

    @property
    def volumes(self) -> torch.Tensor:
        """(m,) float64 summed volume a pair."""
        return self._part(self._pairs_at + 2 * self.npairs,
                          self.npairs).view(torch.float64)

    @property
    def intra(self) -> torch.Tensor:
        """(k,) float64 volumes of the intra-cluster edges, in edge
        order."""
        return self._part(self._pairs_at + 3 * self.npairs,
                          self.nintra).view(torch.float64)

    def cpu(self) -> Contraction:
        """The same contraction on the host: one copy of ``packed``."""
        return dataclasses.replace(self, packed=self.packed.cpu())


def in_order_sum(index: torch.Tensor, values: torch.Tensor,
                 nbins: int) -> torch.Tensor:
    """(nbins,) float64 ``np.bincount(index, weights=values)``: each bin's
    values added in index order (``torch.bincount`` on the CPU)."""
    return torch.bincount(index, weights=values,
                          minlength=nbins).to(torch.float64)


def pair_keys(labels: torch.Tensor, edges: torch.Tensor,
              nclusters: int) -> torch.Tensor:
    """(E,) int64 ``c0 * nclusters + c1`` of each edge's clusters, the
    sentinel ``nclusters ** 2`` where both lie in one cluster."""
    ce = labels[edges]
    return torch.where(ce[:, 0] == ce[:, 1], nclusters * nclusters,
                       ce[:, 0] * nclusters + ce[:, 1])


def contract_ref(labels: torch.Tensor, edges: torch.Tensor,
                 edge_weights: torch.Tensor, coords: torch.Tensor,
                 task_weights: torch.Tensor | None = None, *,
                 nclusters: int) -> Contraction:
    """The contraction of :func:`.ops.contract` (its arguments) on CPU
    tensors."""
    if labels.device.type != "cpu":
        raise ValueError("the plain version of contract takes CPU tensors "
                         f"(got {labels.device})")
    n, d = coords.shape
    nc = nclusters
    if edges.numel() and (bool((edges < 0).any())
                          or bool((edges >= n).any())):
        raise ValueError(f"an edge endpoint lies outside [0, {n})")
    if n and (bool((labels < 0).any()) or bool((labels >= nc).any())):
        raise ValueError(f"a cluster label lies outside [0, {nc})")
    w = (torch.ones(n, dtype=torch.float64) if task_weights is None
         else task_weights)
    sizes = torch.bincount(labels, minlength=nc)
    cw = in_order_sum(labels, w, nc)
    denom = torch.where(cw > 0, cw, 1.0)
    cents = torch.stack([in_order_sum(labels, coords[:, j] * w, nc) / denom
                         for j in range(d)], dim=1)

    sk, si = torch.sort(pair_keys(labels, edges, nc), stable=True)
    ninter = int((sk < nc * nc).sum())
    inter = sk[:ninter]
    head = torch.ones(ninter, dtype=torch.bool)
    head[1:] = inter[1:] != inter[:-1]
    npairs = int(head.sum())
    vol = in_order_sum(torch.cumsum(head, 0) - 1, edge_weights[si[:ninter]],
                       npairs)
    pairs = inter[head]
    intra = edge_weights[si[ninter:]]
    packed = torch.cat([
        sizes, cw.view(torch.int64), cents.reshape(-1).view(torch.int64),
        torch.stack([pairs // nc, pairs % nc], dim=1).reshape(-1),
        vol.view(torch.int64), intra.view(torch.int64)])
    return Contraction(packed, nc, d, npairs, len(intra))
