"""The BERT text tower: config, encoder, WordPiece tokenizer and weight readers.

Counterpart of temporalalignnet_tpu/models/net.py::BertEncoder, which wraps
transformers' FlaxBertModule (reference model/tan_model.py:37-38 loads
bert-base-uncased), and of the ``transformers.BertTokenizer`` /
``BertConfig`` / ``FlaxBertModel.from_pretrained`` calls of the JAX CLIs.
The port needs no ``transformers``:

- ``BertConfig``: the fields of an HF ``config.json`` the encoder reads,
  defaults bert-base-uncased (width 768, 12 layers of 12 heads of 64, MLP
  3072, vocab 30522, 512 positions, 2 token types, LayerNorm eps 1e-12,
  exact GELU).
- ``BertEncoder``: HF ``BertModel``'s module tree and parameter names
  (``embeddings.*``, ``encoder.layer.{i}.attention.self.{query,key,value}``,
  ``attention.output.{dense,LayerNorm}``, ``intermediate.dense``,
  ``output.{dense,LayerNorm}``, ``pooler.dense``), so its state_dict is HF's
  key space.  As JAX calls it: token types all 0, positions ``arange(W)``, no
  dropout (FlaxBertModule runs deterministic), the key padding from
  ``attention_mask == 0``; returns {last_hidden_state, pooler_output} with
  the pooler ``tanh(dense(h[:, 0]))``.  Self-attention goes through
  ``ops.attention.multihead_attention``: the Hopper kernels on the card
  (q, k, v contiguous [B, H, W, 64]), the plain version on the CPU.  HF adds
  ``finfo.min`` to padded keys and the kernel -1e30: a fully padded row (a
  padded sentence slot) averages V uniformly either way.
- ``BertTokenizer``: ``transformers.BertTokenizer`` as the CLIs call it on one
  sentence: the special tokens split out first, then BasicTokenizer (clean,
  CJK spacing, NFC, lower-casing and NFD accent stripping, punctuation split),
  greedy longest-match WordPiece (``[UNK]`` past 100 characters or when a
  word does not split), and ``[CLS] ... [SEP]``.  ``__call__`` returns
  {input_ids, attention_mask} as the datasets read them.
- ``load_bert_dir``: config.json, vocab.txt with tokenizer_config.json, and
  the weights of ``model.safetensors`` (read by ``read_safetensors``, stdlib
  and torch) or ``pytorch_model.bin`` (``torch.load(weights_only=True)``),
  put in the encoder's key space by ``bert_state_dict``, a token
  classifier's ``classifier.*`` split off first (``split_classifier``).  A
  directory whose only weights are ``flax_model.msgpack`` is refused.
- ``BertForTokenClassification``: HF's token classifier in eval mode (the
  punctuator of ``tools/sentencify.py``): ``bert`` without the pooler, and
  ``classifier``; its state_dict is HF's key space.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from temporalalignnet_torch.ops.attention import multihead_attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    pad_token_id: int = 0
    initializer_range: float = 0.02

    @classmethod
    def from_json_file(cls, path: str) -> "BertConfig":
        with open(path) as f:
            raw = json.load(f)
        cfg = cls(**{f.name: raw[f.name] for f in dataclasses.fields(cls) if f.name in raw})
        if cfg.hidden_act != "gelu":
            raise ValueError(f"{path}: hidden_act {cfg.hidden_act!r}; the port's BERT takes "
                             "'gelu' (exact), bert-base-uncased's")
        return cfg

    def to_json_file(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"model_type": "bert", **dataclasses.asdict(self)}, f, indent=2)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            padding_idx=cfg.pad_token_id)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        W = input_ids.shape[-1]
        pos = torch.arange(W, device=input_ids.device)
        # token types all 0 (net.py:43-49 of the JAX package)
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings.weight[0])
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        split = lambda t: t.view(B, S, self.heads, D // self.heads).transpose(1, 2).contiguous()
        out = multihead_attention(split(self.query(x)), split(self.key(x)), split(self.value(x)),
                                  key_padding_mask)
        return out.transpose(1, 2).reshape(B, S, D)


class BertDenseLayerNorm(nn.Module):
    """``LayerNorm(dense(h) + residual)``: HF's BertSelfOutput and BertOutput."""

    def __init__(self, d_in: int, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(d_in, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(h) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertDenseLayerNorm(cfg.hidden_size, cfg)

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x, key_padding_mask), x)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(x))  # exact (erf) GELU, hidden_act 'gelu'


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertDenseLayerNorm(cfg.intermediate_size, cfg)

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor) -> torch.Tensor:
        h = self.attention(x, key_padding_mask)
        return self.output(self.intermediate(h), h)


class BertLayers(nn.Module):
    """HF's ``encoder``: the ``layer.{i}`` list."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor) -> torch.Tensor:
        for layer in self.layer:
            x = layer(x, key_padding_mask)
        return x


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(h[:, 0]))


class BertEncoder(nn.Module):
    """[B, W] token ids -> {last_hidden_state [B, W, D], pooler_output [B, D]}
    (without the pooler, ``add_pooling_layer=False`` as HF's token
    classifier builds its ``bert``: last_hidden_state only)."""

    def __init__(self, cfg: Optional[BertConfig] = None, add_pooling_layer: bool = True):
        super().__init__()
        self.cfg = cfg or BertConfig()
        self.embeddings = BertEmbeddings(self.cfg)
        self.encoder = BertLayers(self.cfg)
        self.pooler = BertPooler(self.cfg) if add_pooling_layer else None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "BertEncoder":
        """HF BertPreTrainedModel._init_weights: Linear and Embedding weights
        N(0, initializer_range), biases 0, LayerNorm 1 and 0, the padding
        row of the word embeddings 0; draws from ``generator``."""
        std = self.cfg.initializer_range
        for name, p in self.named_parameters():
            if "LayerNorm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * std)
        self.embeddings.word_embeddings.weight[self.cfg.pad_token_id] = 0.0
        return self

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        h = self.encoder(self.embeddings(input_ids), (attention_mask == 0).contiguous())
        if self.pooler is None:
            return {"last_hidden_state": h}
        return {"last_hidden_state": h, "pooler_output": self.pooler(h)}


class BertForTokenClassification(nn.Module):
    """HF ``BertForTokenClassification`` in eval mode: ``bert`` (no pooler),
    dropout as identity, ``classifier`` Linear(hidden, num_labels); its
    state_dict is HF's key space (``bert.*``, ``classifier.*``).
    [B, W] ids -> [B, W, num_labels] logits."""

    def __init__(self, cfg: BertConfig, num_labels: int):
        super().__init__()
        self.bert = BertEncoder(cfg, add_pooling_layer=False)
        self.classifier = nn.Linear(cfg.hidden_size, num_labels)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.classifier(self.bert(input_ids, attention_mask)["last_hidden_state"])


def num_labels(config_path: str) -> int:
    """The labels of an HF config.json: its ``id2label``, else ``num_labels``,
    else HF's default 2."""
    with open(config_path) as f:
        raw = json.load(f)
    return len(raw["id2label"]) if "id2label" in raw else int(raw.get("num_labels", 2))


# ---------------------------------------------------------------------------
# Tokenizer (transformers' BasicTokenizer + WordpieceTokenizer)
# ---------------------------------------------------------------------------

SPECIAL_TOKENS = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)  # every non-letter, non-digit ASCII character counts
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


def _split_punctuation(word: str) -> List[str]:
    out: List[str] = []
    start_new = True
    for ch in word:
        if _is_punctuation(ch):
            out.append(ch)
            start_new = True
        else:
            if start_new:
                out.append("")
            start_new = False
            out[-1] += ch
    return out


def load_vocab(path: str) -> Dict[str, int]:
    """vocab.txt: one token a line, id = line number (a repeated token keeps
    its last line's, as transformers' load_vocab)."""
    vocab: Dict[str, int] = collections.OrderedDict()
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f.readlines()):
            vocab[line.rstrip("\n")] = i
    return vocab


class BertTokenizer:
    """WordPiece over ``vocab`` (a token -> id dict or a vocab.txt path)."""

    def __init__(self, vocab: Union[str, Dict[str, int]], do_lower_case: bool = True,
                 tokenize_chinese_chars: bool = True, strip_accents: Optional[bool] = None,
                 max_input_chars_per_word: int = 100):
        self.vocab = load_vocab(vocab) if isinstance(vocab, str) else dict(vocab)
        self.vocab_size = len(self.vocab)
        self.do_lower_case = do_lower_case
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.strip_accents = strip_accents
        self.max_input_chars_per_word = max_input_chars_per_word
        self.unk_id = self.vocab["[UNK]"]
        self.cls_id, self.sep_id = self.vocab["[CLS]"], self.vocab["[SEP]"]
        self.specials = [t for t in SPECIAL_TOKENS if t in self.vocab]

    @classmethod
    def from_dir(cls, path: str) -> "BertTokenizer":
        """vocab.txt with tokenizer_config.json's options where it has them."""
        opts = {}
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                raw = json.load(f)
            opts = {k: raw[k] for k in ("do_lower_case", "tokenize_chinese_chars",
                                        "strip_accents") if k in raw}
        return cls(os.path.join(path, "vocab.txt"), **opts)

    def _split_specials(self, text: str) -> List[str]:
        """Text pieces with every special token a piece of its own."""
        pieces, i, start = [], 0, 0
        while i < len(text):
            hit = next((t for t in self.specials if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            pieces += [text[start:i], hit]
            i = start = i + len(hit)
        return [p for p in pieces + [text[start:]] if p]

    def _basic(self, text: str) -> List[str]:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_whitespace(ch):
                chars.append(" ")
            elif self.tokenize_chinese_chars and _is_cjk(cp):
                chars += [" ", ch, " "]
            else:
                chars.append(ch)
        words = []
        for word in unicodedata.normalize("NFC", "".join(chars)).split():
            if self.do_lower_case:
                word = word.lower()
            if (self.do_lower_case and self.strip_accents is not False) or self.strip_accents:
                word = "".join(c for c in unicodedata.normalize("NFD", word)
                               if unicodedata.category(c) != "Mn")
            words += _split_punctuation(word)
        return " ".join(words).split()

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return ["[UNK]"]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = ("##" if start else "") + word[start:end]
                if piece in self.vocab:
                    break
                end -= 1
            else:
                return ["[UNK]"]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        tokens: List[str] = []
        for piece in self._split_specials(text):
            if piece in self.specials:
                tokens.append(piece)
                continue
            if self.do_lower_case:  # character by character, as transformers does first
                piece = "".join(c.lower() for c in piece)
            for word in self._basic(piece):
                tokens += self._wordpiece(word)
        return tokens

    def encode(self, text: str) -> List[int]:
        """[CLS] + WordPiece ids + [SEP]."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        return [self.cls_id] + ids + [self.sep_id]

    def __call__(self, inputs: Union[str, Sequence[str]]) -> Dict[str, list]:
        """One sentence -> flat id and mask lists; a list of sentences -> a
        list of each (no padding, as transformers' default)."""
        if isinstance(inputs, str):
            ids = self.encode(inputs)
            return {"input_ids": ids, "attention_mask": [1] * len(ids)}
        ids = [self.encode(s) for s in inputs]
        return {"input_ids": ids, "attention_mask": [[1] * len(r) for r in ids]}


# ---------------------------------------------------------------------------
# Weight files
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
                       "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
                       "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file: an 8-byte little-endian header length, a JSON
    header {name: {dtype, shape, data_offsets}}, then the raw little-endian
    buffers (offsets from the end of the header)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        if end == begin:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        raw = torch.frombuffer(data, dtype=torch.uint8, count=end - begin, offset=begin).clone()
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def split_classifier(sd: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor],
                                                           Dict[str, torch.Tensor]]:
    """(everything else, the token classifier's ``classifier.*`` weights in
    f32 under ``weight`` / ``bias``) of an HF BERT weight file."""
    head = {k[len("classifier."):]: torch.as_tensor(v).float()
            for k, v in sd.items() if k.startswith("classifier.")}
    return {k: v for k, v in sd.items() if not k.startswith("classifier.")}, head


def bert_state_dict(sd: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """HF BERT weights (BertModel, or BertForPreTraining and the like under
    ``bert.``) -> BertEncoder's keys in f32: the ``bert.`` prefix stripped,
    the old LayerNorm names ``gamma``/``beta`` renamed, the ``cls.*`` heads
    and the position/token-type id buffers dropped.  A token classifier's
    ``classifier.*`` must be split off first (``split_classifier``).
    Returns (weights, the report of what was dropped)."""
    out, report = {}, []
    for key, value in sd.items():
        if key.startswith("bert."):
            key = key[len("bert."):]
        if key.startswith("cls."):
            report.append(f"dropped (pre-training head): {key}")
            continue
        if key.startswith("classifier."):
            raise ValueError(f"{key}: a token classifier's head; split it off with "
                             "split_classifier")
        if key.endswith(("embeddings.position_ids", "embeddings.token_type_ids")):
            continue
        if key.endswith(".gamma"):
            key = key[:-len("gamma")] + "weight"
        elif key.endswith(".beta"):
            key = key[:-len("beta")] + "bias"
        out[key] = torch.as_tensor(value).float()
    return out, report


@dataclasses.dataclass
class BertDir:
    path: str
    config: BertConfig
    tokenizer: BertTokenizer
    weights: Optional[Dict[str, torch.Tensor]]  # BertEncoder keys; None: no weight file
    weight_file: Optional[str]
    report: List[str]
    classifier: Dict[str, torch.Tensor]  # a token classifier's head (weight, bias), or {}


def load_bert_dir(path: str) -> BertDir:
    """An HF BERT directory (bert-base-uncased's layout): config.json,
    vocab.txt (+ tokenizer_config.json) and model.safetensors or
    pytorch_model.bin, where there is one."""
    config = BertConfig.from_json_file(os.path.join(path, "config.json"))
    tokenizer = BertTokenizer.from_dir(path)
    for name, read in (("model.safetensors", read_safetensors),
                       ("pytorch_model.bin", lambda p: torch.load(p, map_location="cpu",
                                                                  weights_only=True))):
        file = os.path.join(path, name)
        if os.path.exists(file):
            rest, head = split_classifier(read(file))
            weights, report = bert_state_dict(rest)
            return BertDir(path, config, tokenizer, weights, file, report, head)
    if os.path.exists(os.path.join(path, "flax_model.msgpack")):
        raise ValueError(f"{path}: its only weights are flax_model.msgpack (Flax's msgpack "
                         "format), which the port does not read; give it model.safetensors "
                         "or pytorch_model.bin")
    return BertDir(path, config, tokenizer, None, None, [], {})


def write_bert_dir(path: str, config: BertConfig, vocab: Sequence[str],
                   weights: Optional[Dict[str, torch.Tensor]] = None,
                   do_lower_case: bool = True) -> None:
    """The files ``load_bert_dir`` reads: config.json, vocab.txt,
    tokenizer_config.json and, with ``weights``, pytorch_model.bin (the
    weights as given, e.g. under ``bert.``)."""
    os.makedirs(path, exist_ok=True)
    config.to_json_file(os.path.join(path, "config.json"))
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("".join(t + "\n" for t in vocab))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": do_lower_case}, f)
    if weights is not None:
        torch.save(weights, os.path.join(path, "pytorch_model.bin"))

