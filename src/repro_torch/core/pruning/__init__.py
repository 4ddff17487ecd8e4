"""Structured pruning: dependency groups (the U-Net's and every
transformer config's), L2 criteria, rank masks, the Omega regularizer
and compaction."""
from repro_torch.core.pruning.compact import (compact, compact_config,
                                              compact_params)
from repro_torch.core.pruning.criteria import (l2_scores, member_table,
                                               random_scores, sq_norms)
from repro_torch.core.pruning.groups import (GroupMember, PruneGroup,
                                             build_groups, get_path,
                                             set_path, unet_groups)
from repro_torch.core.pruning.masks import (alignment_for, apply_masks,
                                            keep_indices, kept_count,
                                            make_masks, sparsity_report)
from repro_torch.core.pruning.regularizer import depth_lambdas, omega

__all__ = ["GroupMember", "PruneGroup", "alignment_for", "apply_masks",
           "build_groups", "compact", "compact_config", "compact_params",
           "depth_lambdas", "get_path", "keep_indices", "kept_count",
           "l2_scores", "make_masks", "member_table", "omega",
           "random_scores", "set_path", "sparsity_report", "sq_norms",
           "unet_groups"]
