from temporalalignnet_torch.eval.align import AlignmentEvaluator, alignment_metrics
from temporalalignnet_torch.eval.metrics import retrieval_metrics, roc_auc_score
from temporalalignnet_torch.eval.pack import pack_video_table

__all__ = ["AlignmentEvaluator", "alignment_metrics", "pack_video_table",
           "retrieval_metrics", "roc_auc_score"]
