"""Meters, string metrics, visualizations and cost reports (counterpart of
tpgsr_tpu/utils/)."""

from tpgsr_tpu_torch.utils.meters import AverageMeter
from tpgsr_tpu_torch.utils.metrics import (
    accuracy,
    accuracy_with_lexicon,
    edit_distance,
    edit_distance_with_lexicon,
    levenshtein,
    rec_post_process,
)

__all__ = [
    "AverageMeter",
    "accuracy",
    "accuracy_with_lexicon",
    "edit_distance",
    "edit_distance_with_lexicon",
    "levenshtein",
    "rec_post_process",
]
