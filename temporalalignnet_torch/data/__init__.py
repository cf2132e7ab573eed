from temporalalignnet_torch.data.htm_align import HTMAlignDataset
from temporalalignnet_torch.data.padding import pad_tokens, pad_video_by_last
from temporalalignnet_torch.data.synthetic import synthetic_video_corpus

__all__ = ["HTMAlignDataset", "pad_tokens", "pad_video_by_last", "synthetic_video_corpus"]
