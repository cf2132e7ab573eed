from temporalalignnet_torch.data.htm import (
    HTMFeatureDataset,
    JsonlCaptionStore,
    build_vlen_table,
    load_captions,
    load_holdout,
    stack_samples,
)
from temporalalignnet_torch.data.htm_align import HTMAlignDataset
from temporalalignnet_torch.data.padding import pad_tokens, pad_video_by_last
from temporalalignnet_torch.data.prefetch import TrainLoader
from temporalalignnet_torch.data.synthetic import synthetic_batch, synthetic_video_corpus

__all__ = ["HTMAlignDataset", "HTMFeatureDataset", "JsonlCaptionStore", "TrainLoader",
           "build_vlen_table", "load_captions", "load_holdout", "pad_tokens",
           "pad_video_by_last", "stack_samples", "synthetic_batch", "synthetic_video_corpus"]
