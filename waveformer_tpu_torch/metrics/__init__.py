"""Segmentation metrics (a copy of `waveformer_tpu.metrics`)."""

from waveformer_tpu_torch.metrics.segmentation import (  # noqa: F401
    ALL_METRICS,
    ConfusionStats,
    average_surface_distance,
    average_surface_distance_symmetric,
    brats_case_metrics,
    cal_metric,
    convert_labels_brats,
    dice,
    dice_torch,
    evaluate_metrics,
    hausdorff_distance,
    hausdorff_distance_95,
    multiclass_case_metrics,
    surface_distances,
)
