"""The hierarchy's contraction of a task graph onto its clusters, on the
card (``contract``): one kernel keys each edge by its clusters' pair, a
stable device sort groups the pairs, and segment kernels sum each pair's
volumes and each cluster's weights and centroid in order, with numpy's
bits.

:func:`contract` is the wrapper :func:`repro_torch.hier.aggregate_tasks`
calls; :func:`contract_ref` is its plain-torch version.
"""

from .ops import contract
from .ref import Contraction, contract_ref

__all__ = ["Contraction", "contract", "contract_ref"]
