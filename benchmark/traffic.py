"""The traffic generator: a cell's ``traffic`` parameters (its workload file)
and a seed in, a pool of distinct batches out, made on the device in a few
large calls.  The same seed gives the same batches; every seed gives the
same shapes and the same amount of work.

One kind so far (``traffic["kind"]``):

- ``windows``: TAN training or eval windows, ``batch`` windows of
  ``seq_len`` 1-fps features of ``feature_dim`` each with ``sentences``
  sentences of ``words`` tokens.  Each window holds between
  ``min_sentences`` and ``sentences`` sentences (the rest padding), whose
  spans split the window at random boundaries at least ``edge`` steps from
  its ends; a sentence has ``words_per_sentence`` [lo, hi) tokens drawn from
  [1, vocab); the features inside a sentence's span carry ``signal`` · √C
  along a direction tied to its tokens (a fixed random projection of token
  ids modulo ``projection_rows``), so the alignment is learnable, as the
  port's ``data/synthetic.py`` plants it.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def make_pool(traffic: dict, vocab_size: int, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    kind = traffic["kind"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    if kind == "windows":
        return [_windows(traffic, vocab_size, gen, device) for _ in range(traffic["pool"])]
    raise ValueError(f"traffic kind {kind!r}: windows")


def _tokens(n_rows: int, words: int, lo: int, hi: int, vocab: int, gen, device):
    """[n_rows, words] ids: a length in [lo, hi) per row, tokens in [1, vocab)."""
    ids = torch.randint(1, vocab, (n_rows, words), generator=gen, device=device)
    length = torch.randint(lo, hi, (n_rows, 1), generator=gen, device=device)
    return torch.where(torch.arange(words, device=device) < length, ids, 0)


def _windows(t: dict, vocab: int, gen, device) -> Dict[str, torch.Tensor]:
    B, T, N, W, C = t["batch"], t["seq_len"], t["sentences"], t["words"], t["feature_dim"]
    edge = t["edge"]
    n_sent = torch.randint(t["min_sentences"], N + 1, (B, 1), generator=gen, device=device)
    # n_sent - 1 distinct boundaries in [edge, T - edge): the lowest ranks of a random order
    order = torch.rand(B, T - 2 * edge, generator=gen, device=device).argsort(1).argsort(1)
    is_bound = torch.zeros(B, T, dtype=torch.bool, device=device)
    is_bound[:, edge:T - edge] = order < (n_sent - 1)
    sent_of_step = is_bound.long().cumsum(1)  # [B, T]: the sentence each step belongs to
    span = sent_of_step[:, None, :] == torch.arange(N, device=device)[None, :, None]  # [B, N, T]
    steps = torch.arange(T, device=device)
    start = torch.where(span, steps, T).amin(-1)
    end = torch.where(span, steps + 1, 0).amax(-1)
    text_pad = torch.arange(N, device=device)[None] >= n_sent  # [B, N]
    lo, hi = t["words_per_sentence"]
    ids = _tokens(B * N, W, lo, hi, vocab, gen, device).view(B, N, W)
    ids = torch.where(text_pad[..., None], 0, ids)
    proj = torch.randn(t["projection_rows"], C, generator=gen, device=device)
    valid = (ids != 0).float()
    direction = (proj[ids % t["projection_rows"]] * valid[..., None]).sum(2)
    direction = direction / (direction.norm(dim=-1, keepdim=True) + 1e-6)  # [B, N, C]
    video = torch.randn(B, T, C, generator=gen, device=device)
    video += t["signal"] * C ** 0.5 * torch.einsum("bnt,bnc->btc", span.float(), direction)
    start, end = start.float(), end.float()
    start = torch.where(text_pad, 0.0, start)
    end = torch.where(text_pad, 0.0, end)
    return {"video": video,
            "video_padding_mask": torch.zeros(B, T, dtype=torch.bool, device=device),
            "input_ids": ids.int(),
            "text_padding_mask": text_pad,
            "start": start, "end": end,
            "abs_text_pos": torch.stack([start / T, end / T], -1)}

