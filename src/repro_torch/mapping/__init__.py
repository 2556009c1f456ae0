"""repro_torch.mapping — the unified geometric task-mapping pipeline.

One engine behind every mapping entry point in the repo.  The paper's
Algorithm 1 (consistent geometric ordering of tasks and processors) is
decomposed into pluggable stages:

1. **machine transforms** — torus shifting, bandwidth scaling, dim
   drops, box lifts (:meth:`MappingPipeline.machine_coords`);
2. **partitioner backend** — the level-synchronous vectorised
   Multi-Jagged engine (:mod:`repro_torch.core.partition`) or the recursive
   reference, selected per call;
3. **part matching** — equal part numbers task<->processor, including
   the tnum<pnum closest-subset case (:func:`match_parts`);
4. **candidate search** — one batched engine scoring every rotation /
   coordinate-scaling candidate with vectorised ``weighted_hops`` and
   per-link traffic evaluation (:class:`CandidateSearch`).

``repro_torch.core.mapping.Mapper`` (the paper's Z2) and the serve layer
delegate here — there is exactly one rotation/candidate-search loop.
"""

from .candidates import Candidate, CandidateSearch, rotation_candidates
from .pipeline import (HierarchySpec, Level, MappingPipeline,
                       MappingResult, PipelineConfig, match_parts,
                       shared_pipeline)

__all__ = [
    "Candidate", "CandidateSearch", "HierarchySpec", "Level",
    "MappingPipeline", "MappingResult", "PipelineConfig", "match_parts",
    "rotation_candidates", "shared_pipeline",
]
