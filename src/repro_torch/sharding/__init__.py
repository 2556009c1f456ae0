"""repro_torch.sharding — the logical-axis sharding rules."""

from .rules import (DEFAULT_RULES, PartitionSpec, logical, spec_for_axes,
                    tree_shardings)

__all__ = ["DEFAULT_RULES", "PartitionSpec", "logical", "spec_for_axes",
           "tree_shardings"]
