"""Zero-shot YouCook2 text->video retrieval (counterpart of
temporalalignnet_tpu/eval/retrieval.py; reference
eval/eval_zeroshot_retrieval.py:157-256).

Per clip annotation: encode ``num_clips`` staggered windows with the dual
video encoder (last layer), keep only the annotated segment, l2-normalize per
timestep, then average over time and clips; dot against the pooled,
normalized text features; report raw, mean-centred (``C-``) and standardized
(``S-``) R1/R5/R10/MR.

Each unique video goes to the device once, packed at its true length; the
windows are gathered there (indices clamped to the video as the reference's
``np.clip``).  Windows of L = clip(2·duration, 32, 256) steps pad to
Lb = round_up(L, 32) with a key-padding mask; clips group by (Lb,
interpolate) and each group runs in forward calls of at most
``EvalConfig.batch_windows`` windows.  Windows of L >= seq_len resize the
first seq_len pos-enc rows onto their L valid steps (``effective_len``).

With ``group`` (a process group) each forward call's clips split over the
ranks in contiguous blocks and the pooled features are gathered back to
every rank (``parallel/mesh.py``); the text features are small and every
rank computes them all, as JAX replicates them (eval/retrieval.py:75-95,
232-248).  Every rank returns the 1-process metrics.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from temporalalignnet_torch.core.config import EvalConfig
from temporalalignnet_torch.eval.metrics import retrieval_metrics
from temporalalignnet_torch.eval.pack import _round_up, pack_video_table
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.parallel.mesh import sharded_rows


def plan_clip_windows(start: float, end: float, num_clips: int = 10):
    """Window placement only (no gather): returns (chosen_start [K], which may
    be negative, chosen_vlen, start_idx [K], end_idx [K]) per
    eval_zeroshot_retrieval.py:105-141: chosen_vlen = clip(2·duration, 32,
    256); the windows are staggered to cover (or tile) the annotated segment."""
    duration = int(np.floor(end - start))
    chosen_vlen = int(np.clip(duration * 2, 32, 256))
    if chosen_vlen >= duration:
        lead = np.floor(np.linspace(0.25 * (chosen_vlen - duration),
                                    0.75 * (chosen_vlen - duration), num_clips)).astype(int)
        chosen_start = int(start) - lead
        start_idx, end_idx = lead, lead + duration
    else:
        lag = np.floor(np.linspace(0.25 * (duration - chosen_vlen),
                                   0.75 * (duration - chosen_vlen), num_clips)).astype(int)
        chosen_start = int(start) + lag
        start_idx = np.zeros_like(lag)
        end_idx = np.zeros_like(lag) + chosen_vlen
    return chosen_start, chosen_vlen, start_idx, end_idx


def sample_clip_windows(feature: np.ndarray, start: float, end: float, num_clips: int = 10):
    """Host-side gather form of ``plan_clip_windows``: (windows [K, L, C],
    start_idx, end_idx)."""
    vlen = feature.shape[0]
    chosen_start, chosen_vlen, start_idx, end_idx = plan_clip_windows(start, end, num_clips)
    idx = np.clip(chosen_start[:, None] + np.arange(chosen_vlen)[None, :], 0, vlen - 1)
    return feature[idx], start_idx, end_idx


class RetrievalEvaluator:
    """Clip and text features and the retrieval metrics, on the device of
    the model's parameters (a TANWithText or a RawFeatureBaseline).
    ``items``: {'video': np [vlen, C], 'start', 'end', 'input_ids': np [W]
    int}, optionally 'vid' (items with the same 'vid' share one copy of the
    video).  ``group``: the process group whose ranks share the clips."""

    def __init__(self, model: torch.nn.Module, cfg: EvalConfig, group=None):
        self.model = model.eval()
        self.cfg = cfg
        self.group = group
        self.device = next(model.parameters()).device

    def _prepare_item(self, it: Dict) -> Tuple[np.ndarray, int, int, np.ndarray, np.ndarray, bool]:
        """(window starts [K], L, Lb, key padding [K, Lb], segment mask [K, Lb],
        interpolate) for one clip (eval_zeroshot_retrieval.py:181-184)."""
        K = self.cfg.num_clips
        starts, L, s_idx, e_idx = plan_clip_windows(it["start"], it["end"], K)
        Lb = _round_up(L, 32)
        wpad = np.broadcast_to(np.arange(Lb) >= L, (K, Lb)).copy()
        seg = np.zeros((K, Lb), bool)
        for k in range(K):
            seg[k, s_idx[k]:e_idx[k]] = True
        return starts, L, Lb, wpad, seg, L >= self.cfg.seq_len

    def _pooled(self, wins, wpad, seg, eff_len, interpolate: bool) -> torch.Tensor:
        """[q, K, Lb, C] windows -> [q, C] pooled clip features: the last
        layer normalized per timestep, averaged over the segment and the
        clips, normalized (eval_zeroshot_retrieval.py:201-203)."""
        q, K, Lb, C = wins.shape
        feats = self.model.visual_feature(
            wins.reshape(q * K, Lb, C), wpad.reshape(q * K, Lb),
            interpolate_from=self.cfg.seq_len if interpolate else None,
            effective_len=eff_len.repeat_interleave(K) if interpolate else None,
        )[:, -1].float()
        feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
        m = seg.reshape(q * K, Lb, 1).float()
        per_clip = (feats * m).sum(1) / m.sum(1).clamp_min(1e-6)
        pooled = per_clip.reshape(q, K, -1).mean(1)
        return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)

    @torch.inference_mode()
    def clip_features(self, items: Sequence[Dict]) -> np.ndarray:
        """Pooled l2-normalized visual features per clip, [Q, C] f32."""
        items = list(items)
        preps = [self._prepare_item(it) for it in items]
        dev, K = self.device, self.cfg.num_clips
        keys = [it.get("vid", i) for i, it in enumerate(items)]
        uniq: Dict = {}
        for i, k in enumerate(keys):
            uniq.setdefault(k, np.asarray(items[i]["video"], np.float32))
        table, uoffs = pack_video_table(list(uniq.values()), self.model.dtype)
        table = table.to(dev)
        off_of = dict(zip(uniq.keys(), (int(o) for o in uoffs)))
        vlen_of = {k: v.shape[0] for k, v in uniq.items()}

        groups: Dict[Tuple[int, bool], List[int]] = {}
        for i, p in enumerate(preps):
            groups.setdefault((p[2], p[5]), []).append(i)
        per_call = max(1, self.cfg.batch_windows // K)  # clips per forward call

        def put(a) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a)).to(dev)

        out = None
        for (Lb, interp), idxs in groups.items():
            iota = torch.arange(Lb, device=dev)
            for c0 in range(0, len(idxs), per_call):
                sub = idxs[c0:c0 + per_call]

                def run(lo, hi, sub=sub, iota=iota, interp=interp):
                    part = sub[lo:hi]
                    row_off = put([off_of[keys[i]] for i in part])
                    vlens = put([vlen_of[keys[i]] for i in part])
                    starts = put(np.stack([preps[i][0] for i in part]))
                    wpad = put(np.stack([preps[i][3] for i in part]))
                    seg = put(np.stack([preps[i][4] for i in part]))
                    eff_len = put([preps[i][1] for i in part])
                    idx = starts[:, :, None] + iota  # [q, K, Lb]
                    idx = torch.minimum(idx.clamp_min(0), vlens[:, None, None] - 1)
                    wins = table[row_off[:, None, None] + idx]  # [q, K, Lb, C]
                    return self._pooled(wins, wpad, seg, eff_len, interp)

                pooled = sharded_rows(len(sub), lambda lo, hi: (run(lo, hi),), self.group)[0]
                if out is None:
                    out = torch.empty(len(items), pooled.shape[-1], device=dev)
                out[put(sub)] = pooled
        return out.cpu().numpy()

    @torch.inference_mode()
    def text_features(self, input_ids: np.ndarray) -> np.ndarray:
        """[Q, W] token ids -> [Q, C] f32 normalized text features."""
        ids = torch.as_tensor(np.asarray(input_ids)).to(self.device).long()
        emb = self.model.encode_text(ids, (ids != 0).int())
        feat = self.model.textual_feature(emb).float()
        return (feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)).cpu().numpy()

    def evaluate(self, items: Sequence[Dict]) -> Dict[str, float]:
        items = list(items)
        V = self.clip_features(items)
        X = self.text_features(np.stack([np.asarray(it["input_ids"]) for it in items]))
        return retrieval_scores(V, X)


def retrieval_scores(V: np.ndarray, X: np.ndarray) -> Dict[str, float]:
    """Raw, mean-centred and standardized metrics of text X [Q, C] against
    clips V [Q, C] (eval_zeroshot_retrieval.py:239-256)."""
    out = retrieval_metrics(X @ V.T)
    Vc, Xc = V - V.mean(0, keepdims=True), X - X.mean(0, keepdims=True)
    out.update(retrieval_metrics(Xc @ Vc.T, prefix="C-"))
    Vsd = np.where(Vc.std(0, keepdims=True) == 0, 1.0, Vc.std(0, keepdims=True))
    Xsd = np.where(Xc.std(0, keepdims=True) == 0, 1.0, Xc.std(0, keepdims=True))
    out.update(retrieval_metrics((Xc / Xsd) @ (Vc / Vsd).T, prefix="S-"))
    return out


def test_retrieval(model: TANWithText, items, cfg: EvalConfig = EvalConfig()) -> Dict[str, float]:
    """Functional entry mirroring test_retrieval_yc2 (eval_zeroshot_retrieval.py:157)."""
    return RetrievalEvaluator(model, cfg).evaluate(items)
