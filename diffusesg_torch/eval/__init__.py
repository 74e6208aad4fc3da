"""The metric suite: the port's numpy copies of diffusesg_tpu/eval/."""
from .blt import (
    compute_bbox_ioa, get_alignment_loss, get_average_iou, get_overlap_index, get_perceptual_iou,
)
from .graph_stats import (
    adjs_to_graphs, clustering_stats, degree_histograms, degree_stats, eval_acc_lobster_batch,
    eval_acc_lobster_graph, eval_graph_batch, is_lobster_graph, spectral_stats,
)
from .mmd import (
    KERNEL_NAME_TO_FUNC, compute_mmd, gaussian, gaussian_emd, gaussian_emd_kernel_matrix,
    gaussian_kernel_matrix, gaussian_tv, gaussian_tv_kernel_matrix, retrieve_kernels,
)
from .sg_evaluator import SceneGraphEvaluator
from .sg_statistics import compute_sg_statistics
from .voc_f1 import compute_bbox_f1
