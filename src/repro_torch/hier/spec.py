"""Structured description of the mapping hierarchy.

A :class:`HierarchySpec` replaces the old ``hierarchy="flat"|"node"``
string plus flat ``refine_rounds/top/degree`` knobs of
``PipelineConfig``/``MapperConfig``: it is an ordered tuple of
:class:`Level` coarsening steps (fine -> coarse), each carrying its own
group arity and refinement budget, so the N-level recursive hierarchy
of Schulz & Woydt's shared-memory process mapping — pod -> rack ->
node -> socket -> core — becomes a first-class, content-addressable
config value.

Depth terminology (``spec.depth == 1 + len(spec.levels)``):

- depth 1 (``levels == ()``)  : the classic FLAT pipeline — one point
  per core, no coarsening.
- depth 2 (one level)         : the node-granularity map — coarsen
  tasks to node-sized clusters, sweep at router granularity, refine,
  expand.  ``HierarchySpec.node()`` reproduces it bit for bit.
- depth >= 3                  : additional geometric grouping levels
  above the node level; each level divides the top-sweep point count
  by its ``arity`` and gets its own refinement pass on the way down.

The legacy strings keep working as deprecated aliases through
:meth:`HierarchySpec.from_string` (``PipelineConfig`` calls it when
handed a string); :meth:`HierarchySpec.from_machine` derives the node
arity from a :class:`repro_torch.core.Machine`'s core dims.  Specs are frozen
dataclasses, so :func:`repro_torch.core.signature.config_signature`
canonicalises them field by field — two equal specs built through
different constructors produce the SAME cache key (asserted in
tests/test_hierarchy_spec.py).
"""

from __future__ import annotations

import dataclasses
import re

__all__ = ["Level", "HierarchySpec", "HIERARCHY_ALIASES",
           "normalize_config_hierarchy"]

# arity of grouping levels ABOVE the node level when not given
# explicitly ("depth3"/"depth4" aliases, from_machine defaults).  4
# units per group still cuts the top sweep 4x per level, and smaller
# groups keep the medoid abstraction honest: the expansion error the
# intra-group polish must repair grows with group radius, and at arity
# 4 the polished depth-3 map lands within ~4% of depth-2 quality on
# the hier benchmark (arity 8 leaves ~6%, arity 16 ~13%).
DEFAULT_GROUP_ARITY = 4

# refinement-budget defaults — EXACTLY the old PipelineConfig
# refine_rounds/refine_top/refine_degree defaults, so
# ``HierarchySpec.node()`` is bit-identical to the legacy
# ``hierarchy="node"`` path.
DEFAULT_REFINE_ROUNDS = 2
DEFAULT_REFINE_TOP = 64
DEFAULT_REFINE_DEGREE = 4

# grouping-level default for the sparse-QAP pass of deep hierarchies:
# one round.  The intra-group polish below does the bulk repair after
# every group expansion, so the QAP search only needs to catch the
# cross-group moves the polish cannot make.
DEFAULT_QAP_ROUNDS = 1

# rounds of the intra-group polish pass run when a GROUP-level
# assignment is expanded one level down (depth >= 3 only; a depth-2
# spec has no group expansion, so the legacy path never sees it).  The
# per-round gain decays geometrically; 4 rounds capture ~90% of the
# converged improvement at a fraction of the cost.
DEFAULT_POLISH_ROUNDS = 4

HIERARCHY_ALIASES = ("flat", "node", "depth<N>")


@dataclasses.dataclass(frozen=True)
class Level:
    """One coarsening step of the hierarchy (fine -> coarse).

    name          : label of the units this level groups INTO ("node",
                    "rack", "pod", ...) — report/span attribution only.
    arity         : children per group.  ``None`` derives it at map
                    time: the first level takes the machine's
                    cores-per-node (the paper's node granularity),
                    deeper levels take :data:`DEFAULT_GROUP_ARITY`.
    refine_rounds / refine_top / refine_degree :
                    budget of the swap-refinement pass run at THIS
                    level's granularity (rounds, hottest clusters per
                    round, nearest units proposed per cluster) — the
                    same bounds the old flat knobs applied to the
                    single node level.
    refine_mode   : "swap" — the bounded greedy network-nearest swap
                    pass (fused-foldable, the bit-identity
                    baseline); "qap" — the sparse-QAP local search
                    (:func:`repro_torch.hier.refine.refine_qap`): per-cluster
                    best-single-move + pairwise-swap neighbourhoods
                    over the sparse inter-cluster edge set, gain-bucket
                    ordered, monotone with full re-score verify.
    polish_rounds : rounds of the intra-group polish pass
                    (:func:`repro_torch.hier.refine.polish_groups`) run when
                    THIS level's assignment is produced by expanding a
                    group level above it — exact KL-style swap deltas
                    inside every group at once, repairing the member
                    placements the medoid abstraction could not see.
                    Only reachable at depth >= 3 (depth 2 has no group
                    expansion), so it never perturbs the legacy path.
    """

    name: str = "node"
    arity: int | None = None
    refine_rounds: int = DEFAULT_REFINE_ROUNDS
    refine_top: int = DEFAULT_REFINE_TOP
    refine_degree: int = DEFAULT_REFINE_DEGREE
    refine_mode: str = "swap"
    polish_rounds: int = DEFAULT_POLISH_ROUNDS

    def __post_init__(self):
        if self.arity is not None and int(self.arity) < 2:
            raise ValueError(
                f"level {self.name!r}: arity must be >= 2 or None "
                f"(got {self.arity!r})")
        if self.refine_mode not in ("swap", "qap"):
            raise ValueError(
                f"level {self.name!r}: unknown refine_mode "
                f"{self.refine_mode!r}; accepted: 'swap', 'qap'")
        for f in ("refine_rounds", "refine_top", "refine_degree",
                  "polish_rounds"):
            if int(getattr(self, f)) < 0:
                raise ValueError(
                    f"level {self.name!r}: {f} must be >= 0")


_DEPTH_RE = re.compile(r"^depth([0-9]+)$")

# default names for derived grouping levels, innermost first (level 1
# is always the node level; deeper levels walk outward)
_LEVEL_NAMES = ("node", "socket", "rack", "pod")


def _level_name(i: int) -> str:
    return _LEVEL_NAMES[i] if i < len(_LEVEL_NAMES) else f"level{i + 1}"


def _int_prod(seq) -> int:
    out = 1
    for x in seq:
        out *= int(x)
    return out


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """Ordered coarsening levels of the mapping hierarchy.

    ``levels`` runs fine -> coarse: ``levels[0]`` groups tasks/cores
    into nodes, ``levels[1]`` groups nodes, and so on.  An empty tuple
    is the flat pipeline.  Instances are frozen and hashable — they are
    config values and cache-key material.
    """

    levels: tuple = ()

    def __post_init__(self):
        levels = tuple(self.levels)
        if not all(isinstance(lv, Level) for lv in levels):
            raise TypeError("HierarchySpec.levels must contain Level "
                            "instances")
        object.__setattr__(self, "levels", levels)

    # -- identity -------------------------------------------------------

    @property
    def depth(self) -> int:
        """Number of granularities mapped (1 = flat, 2 = node, ...)."""
        return 1 + len(self.levels)

    @property
    def kind(self) -> str:
        """Short label for spans/stats: "flat", "node" or "depthN"."""
        if not self.levels:
            return "flat"
        if len(self.levels) == 1:
            return "node"
        return f"depth{self.depth}"

    @property
    def is_flat(self) -> bool:
        return not self.levels

    # -- constructors ---------------------------------------------------

    @classmethod
    def flat(cls) -> "HierarchySpec":
        """The classic flat pipeline (depth 1, no coarsening)."""
        return cls(())

    @classmethod
    def node(cls, *, refine_rounds: int = DEFAULT_REFINE_ROUNDS,
             refine_top: int = DEFAULT_REFINE_TOP,
             refine_degree: int = DEFAULT_REFINE_DEGREE,
             refine_mode: str = "swap") -> "HierarchySpec":
        """The two-level node-granularity hierarchy (depth 2), with
        the node arity derived from the machine at map time.  Default
        budgets reproduce the legacy ``hierarchy="node"`` path bit for
        bit."""
        return cls((Level("node", None, refine_rounds, refine_top,
                          refine_degree, refine_mode),))

    @classmethod
    def with_depth(cls, n: int, *,
                   group_arity: int = DEFAULT_GROUP_ARITY,
                   refine_rounds: int | None = None,
                   refine_top: int = DEFAULT_REFINE_TOP,
                   refine_degree: int = DEFAULT_REFINE_DEGREE,
                   polish_rounds: int = DEFAULT_POLISH_ROUNDS
                   ) -> "HierarchySpec":
        """An ``n``-granularity hierarchy: the node level plus ``n - 2``
        grouping levels of ``group_arity`` units per group.  Grouping
        levels (depth >= 3) refine with the sparse-QAP local search;
        the node level keeps the fused-foldable swap pass.

        ``refine_rounds=None`` picks per-level defaults: at depth 2 the
        node level keeps :data:`DEFAULT_REFINE_ROUNDS` (bit-identical
        to :meth:`node`); at depth >= 3 the node level's bounded swap
        pass is OFF (``polish_rounds`` of intra-group polish at every
        group expansion supersede it — two swap rounds after the
        polish buy almost no quality for a large share of the
        runtime) and grouping levels run
        :data:`DEFAULT_QAP_ROUNDS` of the QAP search.  An explicit
        ``refine_rounds`` applies to every level (the landing pad for
        the deprecated flat ``refine_rounds=`` kwarg)."""
        if n < 1:
            raise ValueError(f"depth must be >= 1, got {n}")
        if n == 1:
            return cls.flat()
        node_rounds = refine_rounds if refine_rounds is not None else (
            DEFAULT_REFINE_ROUNDS if n == 2 else 0)
        qap_rounds = (refine_rounds if refine_rounds is not None
                      else DEFAULT_QAP_ROUNDS)
        kw = dict(refine_top=refine_top, refine_degree=refine_degree,
                  polish_rounds=polish_rounds)
        levels = [Level("node", None, refine_mode="swap",
                        refine_rounds=node_rounds, **kw)]
        levels += [Level(_level_name(i), group_arity,
                         refine_mode="qap", refine_rounds=qap_rounds,
                         **kw)
                   for i in range(1, n - 1)]
        return cls(tuple(levels))

    @classmethod
    def from_string(cls, name: str, *,
                    refine_rounds: int | None = None,
                    refine_top: int | None = None,
                    refine_degree: int | None = None) -> "HierarchySpec":
        """Parse a hierarchy alias: ``"flat"``, ``"node"`` or
        ``"depthN"`` (N >= 1).  The optional refine knobs override every
        level's budget — this is the landing pad for the deprecated
        flat ``refine_*`` config fields."""
        kw = {k: int(v) for k, v in (("refine_rounds", refine_rounds),
                                     ("refine_top", refine_top),
                                     ("refine_degree", refine_degree))
              if v is not None}
        if name == "flat":
            return cls.flat()
        if name == "node":
            return cls.node(**kw)
        m = _DEPTH_RE.match(name)
        if m:
            return cls.with_depth(int(m.group(1)), **kw)
        raise ValueError(
            f"unknown hierarchy {name!r}; accepted: "
            f"{', '.join(repr(a) for a in HIERARCHY_ALIASES)} "
            f"or a HierarchySpec")

    @classmethod
    def from_machine(cls, machine, depth: int = 2, *,
                     group_arity: int = DEFAULT_GROUP_ARITY,
                     refine_rounds: int = DEFAULT_REFINE_ROUNDS,
                     refine_top: int = DEFAULT_REFINE_TOP,
                     refine_degree: int = DEFAULT_REFINE_DEGREE
                     ) -> "HierarchySpec":
        """Derive a spec from a :class:`repro_torch.core.Machine`: the node
        level's arity is the machine's cores-per-node (product of its
        core dims), deeper levels use ``group_arity``.  Machines
        without core dims keep ``arity=None`` (one cluster per router,
        like the legacy path)."""
        spec = cls.with_depth(depth, group_arity=group_arity,
                              refine_rounds=refine_rounds,
                              refine_top=refine_top,
                              refine_degree=refine_degree)
        if not spec.levels or not machine.core_dims:
            return spec
        nd = machine.ndim - machine.core_dims
        cores = _int_prod(machine.dims[nd:])
        if cores >= 2:
            levels = (dataclasses.replace(spec.levels[0], arity=cores),
                      ) + spec.levels[1:]
            spec = cls(levels)
        return spec

    # -- derived specs (resilience ladder & shims) ----------------------

    def truncated(self, depth: int) -> "HierarchySpec":
        """The same spec cut down to ``depth`` granularities (the
        resilience ladder's depth-degradation rung)."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        return HierarchySpec(self.levels[: depth - 1])

    def with_refine(self, *, rounds: int | None = None,
                    top: int | None = None,
                    degree: int | None = None,
                    polish: int | None = None) -> "HierarchySpec":
        """Every level's refinement budget overridden (``refine_0`` on
        the degradation ladder uses ``rounds=0, polish=0``)."""
        changes = {k: v for k, v in (("refine_rounds", rounds),
                                     ("refine_top", top),
                                     ("refine_degree", degree),
                                     ("polish_rounds", polish))
                   if v is not None}
        return HierarchySpec(tuple(dataclasses.replace(lv, **changes)
                                   for lv in self.levels))

    @property
    def refine_rounds_total(self) -> int:
        return sum(lv.refine_rounds for lv in self.levels)

    @property
    def polish_rounds_total(self) -> int:
        """Total polish budget — nonzero only matters at depth >= 3."""
        return sum(lv.polish_rounds for lv in self.levels)


# -- the config-side deprecation shim ------------------------------------

_LEGACY_REFINE_FIELDS = ("refine_rounds", "refine_top", "refine_degree")


def normalize_config_hierarchy(config) -> None:
    """Shared ``__post_init__`` body of ``PipelineConfig`` and
    ``MapperConfig``: normalise ``config.hierarchy`` to a
    :class:`HierarchySpec` and fold the deprecated flat ``refine_*``
    knobs into it.

    Validation happens HERE — at config construction — so a bad
    hierarchy raises a 4xx-style ``ValueError`` listing the accepted
    values before any mapping work starts (in particular before the
    serve layer admits the request or burns a degradation-ladder
    rung).  The deprecation shim emits a single
    :class:`DeprecationWarning` per construction naming the
    replacement; re-normalising an already-normalised config
    (``dataclasses.replace`` re-runs this) is a silent no-op.
    """
    import warnings

    legacy = {k: getattr(config, k) for k in _LEGACY_REFINE_FIELDS
              if getattr(config, k) is not None}
    h = config.hierarchy
    if isinstance(h, str):
        spec = HierarchySpec.from_string(h, **legacy)  # raises on junk
        if h != "flat" or legacy:
            warnings.warn(
                f"hierarchy={h!r}"
                + (f" with {'/'.join(sorted(legacy))}=" if legacy else "")
                + " is deprecated; pass hierarchy=HierarchySpec"
                ".from_string(...) (or .node()/.with_depth()/"
                ".from_machine()) with per-level refine budgets instead",
                DeprecationWarning, stacklevel=4)
    elif isinstance(h, HierarchySpec):
        spec = h
        if legacy:
            warnings.warn(
                f"the flat {'/'.join(sorted(legacy))} config fields are "
                "deprecated; set the refine budgets on the "
                "HierarchySpec levels instead",
                DeprecationWarning, stacklevel=4)
            spec = spec.with_refine(
                rounds=legacy.get("refine_rounds"),
                top=legacy.get("refine_top"),
                degree=legacy.get("refine_degree"))
    else:
        raise ValueError(
            f"unknown hierarchy {h!r}; accepted: "
            f"{', '.join(repr(a) for a in HIERARCHY_ALIASES)} "
            f"or a HierarchySpec")
    config.hierarchy = spec
    for k in _LEGACY_REFINE_FIELDS:  # folded into the spec above
        setattr(config, k, None)
