from temporalalignnet_torch.models.bert import BertConfig, BertEncoder, BertTokenizer, load_bert_dir
from temporalalignnet_torch.models.clip_text import CLIPTextEncoder, CLIPTokenizer
from temporalalignnet_torch.models.clip_vit import CLIPImageEncoder
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.models.posenc import position_embedding_sine_from_mask
from temporalalignnet_torch.models.tan import TemporalAligner, l2_normalize
from temporalalignnet_torch.models.timesformer import TimeSformerEncoder
from temporalalignnet_torch.models.transformer import TemporalDecoder
from temporalalignnet_torch.models.word2vec import Word2VecEncoder, Word2VecTokenizer

__all__ = ["BertConfig", "BertEncoder", "BertTokenizer", "CLIPImageEncoder", "CLIPTextEncoder",
           "CLIPTokenizer", "TANWithText", "TemporalAligner", "TemporalDecoder",
           "TimeSformerEncoder", "Word2VecEncoder", "Word2VecTokenizer", "l2_normalize",
           "load_bert_dir", "position_embedding_sine_from_mask"]
