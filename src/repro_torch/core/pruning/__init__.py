"""Structured pruning of the U-Net: groups, L2 criteria, rank masks."""
from repro_torch.core.pruning.criteria import (group_sq_norms, l2_scores,
                                               member_unit_sq, random_scores)
from repro_torch.core.pruning.groups import (GroupMember, PruneGroup,
                                             get_path, unet_groups)
from repro_torch.core.pruning.masks import (alignment_for, kept_count,
                                            make_masks)

__all__ = ["GroupMember", "PruneGroup", "alignment_for", "get_path",
           "group_sq_norms", "kept_count", "l2_scores", "make_masks",
           "member_unit_sq", "random_scores", "unet_groups"]
