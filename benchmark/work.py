"""The work a cell's units need, counted from its shapes: model FLOPs for the
``mfu`` metrics and each kernel's bytes and operations for the roofline
shares, with the card's published peaks.

Model FLOPs count the products the forward and the backward of the model
need, 2 per multiply-add, and nothing recomputed: a matrix product's
backward is twice its forward (the input's and the weight's gradient),
once where its input takes no gradient.  Attention counts the valid keys
only.  A kernel's bytes count each input read once and each output written
once; its operations what these inputs need (a backward that recomputes
the probabilities counts that product: the kernel cannot do without it).
Plain Python on shapes; nothing here imports the program under test.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def card_peaks(name: str) -> Dict[str, float]:
    """The data-sheet peaks of the card called ``name`` (the longest key of
    peaks.json that the name contains)."""
    table = json.loads(PEAKS_FILE.read_text())["cards"]
    keys = sorted((k for k in table if k in name), key=len, reverse=True)
    if not keys:
        raise ValueError(f"no peaks for card {name!r} in {PEAKS_FILE.name}")
    return table[keys[0]]


# ------------------------------------------------------------- the kernels


def attention_work(batch: int, heads: int, seq: int, dim: int, valid_keys: int, full: int,
                   passes: int, elem_bytes: int = 2, mask: bool = True) -> Tuple[int, int]:
    """(bytes, operations) of an attention call on q, k, v [batch, heads,
    seq, dim] with ``valid_keys`` valid keys summed over the rows: ``full``
    tensors of q's size read or written whole, K and V read at the valid keys
    only, the [batch, seq] mask once; ``passes`` multiply-adds of length dim
    per head for each (query, valid key) pair."""
    q_numel = batch * heads * seq * dim
    nbytes = (full * q_numel + 2 * valid_keys * heads * dim) * elem_bytes
    nbytes += batch * seq if mask else 0
    return nbytes, 2 * passes * heads * seq * dim * valid_keys


def mha_fwd_work(batch, heads, seq, dim, valid_keys, elem_bytes=2):
    """q, out; QKᵀ, PV."""
    return attention_work(batch, heads, seq, dim, valid_keys, 2, 2, elem_bytes)


def mha_bwd_work(batch, heads, seq, dim, valid_keys, elem_bytes=2):
    """q, dout, dq, dk, dv; QKᵀ, dout Vᵀ, Pᵀ dout, dS K, dSᵀ Q."""
    return attention_work(batch, heads, seq, dim, valid_keys, 5, 5, elem_bytes)


def milnce_work(layers: int, rows: int, cols: int, channels: int, shared_text: bool,
                elem_bytes: int = 2) -> Dict[str, Tuple[int, int]]:
    """(bytes, operations) of the three MIL-NCE kernels on video [S, R, C]
    and text [S, K, C] (or [K, C], shared by the layers): the forward's four
    logsumexps from the logits (2·S·R·K·C), each gradient from the saved
    logsumexps (the logits again, then the product: 4·S·R·K·C)."""
    S, R, K, C = layers, rows, cols, channels
    video = S * R * C
    text = (1 if shared_text else S) * K * C
    feat = (video + text) * elem_bytes + R * K + K  # features, the [R, K] mask, col_valid
    lse = (2 * S * R + 2 * S * K) * 4
    return {"milnce_fwd": (feat + lse, 2 * S * R * K * C),
            "milnce_dv": (feat + 2 * lse + video * elem_bytes, 4 * S * R * K * C),
            "milnce_dt": (feat + 2 * lse + text * elem_bytes, 4 * S * R * K * C)}


def bound_s(nbytes: int, flops: int, peaks: Dict[str, float], flop_peak: str = "bf16_flops"
            ) -> float:
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks[flop_peak])


# ------------------------------------------------------- the TAN's model FLOPs


def linear_flops(tokens: int, fan_in: int, fan_out: int, train: bool,
                 input_grad: bool = True) -> int:
    fwd = 2 * tokens * fan_in * fan_out
    return fwd * (1 + (2 if input_grad else 1)) if train else fwd


def tan_flops(cfg: dict, batch: int, seq: int, sentences: int, words: int,
              dual_valid_keys: int, joint_valid_keys: int, train: bool,
              milnce: bool = False) -> int:
    """Model FLOPs of one TAN forward (and with ``train`` its backward) on
    [batch, seq] video and [batch, sentences, words] text; the valid keys are
    summed over the batch's rows (each the same for every query of a row).
    ``milnce``: Stage 1's loss on the [S, B·T, B·N] logits of both branches,
    and the same-video sims of the head's labels (with the head); without it the eval's
    cosine sims [B, S, T, N] of both branches."""
    D, H = cfg["width"], cfg["heads"]
    hid, dh = cfg["mlp_ratio"] * D, D // H
    B, T, N, W = batch, seq, sentences, words
    f = 0
    # the word2vec tower: fc1 per word (its input, the frozen embedding, takes
    # no gradient), fc2 per sentence; the text and video pre-projections
    f += linear_flops(B * N * W, cfg["word_dim"], cfg["text_hidden_dim"], train, input_grad=False)
    f += linear_flops(B * N, cfg["text_hidden_dim"], cfg["text_embed_dim"], train)
    f += linear_flops(B * N, cfg["text_embed_dim"], D, train)
    f += 2 * linear_flops(B * T, cfg["video_embed_dim"], D, train, input_grad=False)
    for tokens, layers, valid in ((B * T, cfg["num_encoder_layers"], dual_valid_keys),
                                  (B * (T + N), cfg["num_joint_layers"], joint_valid_keys)):
        block = (linear_flops(tokens, D, 3 * D, train) + linear_flops(tokens, D, D, train)
                 + linear_flops(tokens, D, hid, train) + linear_flops(tokens, hid, D, train))
        S = tokens // B
        attn = 4 * H * S * dh * valid  # QKᵀ and PV over the valid keys
        f += layers * (block + (3 * attn if train else attn))
    L = cfg["num_joint_layers"]
    if cfg.get("use_alignability_head"):  # the joint head on every layer, the dual one at eval
        f += linear_flops(B * N * L, D, 1, train) + (0 if train else linear_flops(B * N, D, 1, False))
    if milnce:
        logits = 2 * L * (B * T) * (B * N) * D  # per branch: S layers of [B·T, B·N]
        f += 2 * (3 * logits if train else logits)
        if cfg.get("use_alignability_head"):  # the labels' same-video sims, no gradient
            f += 2 * 2 * B * L * T * N * D
    else:
        f += 2 * 2 * B * L * T * N * D  # joint and dual cosine sims
    return f
