from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.models.tan import TemporalAligner, l2_normalize
from temporalalignnet_torch.models.word2vec import Word2VecEncoder, Word2VecTokenizer

__all__ = ["TANWithText", "TemporalAligner", "Word2VecEncoder", "Word2VecTokenizer",
           "l2_normalize"]
