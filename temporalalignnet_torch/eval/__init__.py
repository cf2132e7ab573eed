from temporalalignnet_torch.eval.align import AlignmentEvaluator, alignment_metrics, test_alignment
from temporalalignnet_torch.eval.metrics import retrieval_metrics, roc_auc_score
from temporalalignnet_torch.eval.pack import pack_video_table
from temporalalignnet_torch.eval.retrieval import (RetrievalEvaluator, plan_clip_windows,
                                                   sample_clip_windows)

__all__ = ["AlignmentEvaluator", "RetrievalEvaluator", "alignment_metrics", "pack_video_table",
           "plan_clip_windows", "retrieval_metrics", "roc_auc_score", "sample_clip_windows",
           "test_alignment"]
