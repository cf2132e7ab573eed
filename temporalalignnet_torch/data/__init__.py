from temporalalignnet_torch.data.htm import (
    HTMFeatureDataset,
    JsonlCaptionStore,
    build_vlen_table,
    load_captions,
    load_holdout,
    stack_samples,
)
from temporalalignnet_torch.data.htm_align import HTMAlignDataset, HTMAlignTrainDataset
from temporalalignnet_torch.data.padding import pad_tokens, pad_video_by_last
from temporalalignnet_torch.data.prefetch import TrainLoader
from temporalalignnet_torch.data.synthetic import synthetic_batch, synthetic_video_corpus
from temporalalignnet_torch.data.yc2 import YC2RetrievalDataset, YC2TrainDataset

__all__ = ["HTMAlignDataset", "HTMAlignTrainDataset", "HTMFeatureDataset", "JsonlCaptionStore",
           "TrainLoader", "build_vlen_table", "load_captions", "load_holdout", "pad_tokens",
           "pad_video_by_last", "stack_samples", "synthetic_batch", "synthetic_video_corpus",
           "YC2RetrievalDataset", "YC2TrainDataset"]
