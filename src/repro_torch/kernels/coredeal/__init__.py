"""The hierarchy's expansion of clusters on routers to tasks on cores, on
the card (``coredeal``): one kernel writes each task's Hilbert index and
router, three stable device sorts order them, and one kernel deals each
router's tasks onto its cores.

:func:`coredeal` is the wrapper :func:`repro_torch.hier.refine.assign_cores`
calls for a device; :func:`coredeal_ref` is its plain-torch version.
"""

from .ops import coredeal
from .ref import coredeal_ref

__all__ = ["coredeal", "coredeal_ref"]
