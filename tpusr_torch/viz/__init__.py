"""The port's figures (port of ``tpusr/viz``): the JAX package's panels,
drawn by the port's own figure writer (``figure.py``, ``render.py``) with
its colormaps and font, written as PNG or JPEG by the port's codecs."""

from tpusr_torch.viz.classic_viz import (
    plot_time_memory_panels,
    plot_psnr_ssim_panels,
    plot_speed_quality_tradeoff_3d,
    plot_error_metrics_grid,
    plot_edge_metrics_grid,
    plot_frequency_distribution_metrics_grid,
    plot_and_save_super_resolution_example,
    plot_and_save_ssim_similarity_maps,
    show_algorithm_ranking,
)
from tpusr_torch.viz.dl_viz import (
    plot_sr_metrics,
    plot_sr_time,
    plot_sr_memory,
    plot_confusion,
    plot_classification_reports_panel,
    plot_4x3,
    plot_confidence_panel,
    classification_report_dict,
)
