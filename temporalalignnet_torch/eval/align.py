"""Zero-shot HTM-Align evaluation (counterpart of temporalalignnet_tpu/eval/align.py).

Replicates eval/eval_zeroshot_align.py:97-252 of the reference.  The
reference runs a Python loop over overlapping 64 s windows with one window per
forward call; here the windows of all videos that share a sentence bucket are
concatenated into one window batch and run in chunks of ``batch_windows``:
each chunk gathers its windows from the packed feature table on the device,
runs the sims, and scatter-adds them into the per-video canvases along time
with ``index_add_``.  Only the stitched canvases come back to the host.

With ``group`` (a process group) each forward call's windows (overlap-seq)
or videos (global) split over the ranks in contiguous blocks, each rank
runs its block, and the results are gathered back to every rank
(``parallel/mesh.py::sharded_rows``), which then
stitches the same canvases: every rank returns the same metrics, those of
the 1-process evaluation (JAX eval/align.py:43-58, 480-530).

Leak-freedom is kept: a window's active sentences are derived only from the
NON-alignable sentences' ASR timestamps (eval_zeroshot_align.py:143-167), and
inactive sentences are key-masked in the joint encoder.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from temporalalignnet_torch.core.config import EvalConfig
from temporalalignnet_torch.eval.metrics import roc_auc_score
from temporalalignnet_torch.eval.pack import _round_up, pack_video_table
from temporalalignnet_torch.parallel.mesh import sharded_rows

MASK_VALUE = -6.0e4
TEMPERATURE = 0.07  # sims are read as logits / 0.07 (train/main.py:183-184)
EPS = 1e-5


class AlignmentEvaluator:
    """Batched overlap-seq / global aligner on the device of the model's
    parameters.  ``model``: a TANWithText or a RawFeatureBaseline (its
    ``encode_text``, ``text_visual_sims``, ``dtype`` and ``cfg``).

    ``corpus`` items: {'video': np [vlen, C], 'sentences': list of
    {'aligned': 0/1, 'start': float, 'end': float, 'input_ids': np [W] int}},
    optionally 'vid' (items with the same 'vid' share one copy of the video).
    ``group``: the process group whose ranks share the forward calls.
    """

    def __init__(self, model: torch.nn.Module, cfg: EvalConfig, group=None):
        self.model = model.eval()
        self.cfg = cfg
        self.group = group
        self.device = next(model.parameters()).device
        # overlap-seq reads the head on joint layer 2, global on the last
        # (eval_zeroshot_align.py:186 vs :213)
        self.a_layer = min(cfg.alignability_layer, model.cfg.num_joint_layers - 1)
        self.use_head = model.cfg.use_alignability_head

    # ---------------------------------------------------------------- host side

    def _active_text_mask(self, idx: int, step: float, num_steps: int, vlen: int,
                          aligned: np.ndarray, mid_ts: np.ndarray) -> Optional[np.ndarray]:
        """Reference active-window selection (eval_zeroshot_align.py:149-167)."""
        seq_len = self.cfg.seq_len
        n_text = aligned.shape[0]
        nonalignable_idx = np.arange(n_text)[~aligned.astype(bool)]
        nonalignable_mid = mid_ts[~aligned.astype(bool)]
        in_window = (step - seq_len <= nonalignable_mid) & (
            nonalignable_mid <= step + 2 * seq_len
        )
        active_na = nonalignable_idx[in_window]
        if len(active_na) == 0:
            return None
        left, right = int(active_na.min()), int(active_na.max())
        if idx <= 3:
            left = 0
        elif idx >= num_steps - 4:
            right = vlen  # reference quirk: clamps via slicing (:166)
        mask = np.zeros(n_text, bool)
        mask[left : right + 1] = True
        return mask

    def _prepare_video(self, item: Dict) -> Dict:
        """Token ids padded to an 8-sentence bucket, and the windows that have
        active sentences: their start steps and [n_windows, n_bucket] masks."""
        seq_len = self.cfg.seq_len
        video = np.asarray(item["video"], np.float32)
        vlen = video.shape[0]
        sents = item["sentences"]
        n_text = len(sents)
        aligned = np.array([s["aligned"] for s in sents])
        starts = np.array([s["start"] for s in sents], np.float32)
        ends = np.array([s["end"] for s in sents], np.float32)
        mid_ts = (starts + ends) / 2.0

        n_bucket = _round_up(n_text, 8)
        ids = np.zeros((n_bucket, len(sents[0]["input_ids"])), np.int32)
        for i, s in enumerate(sents):
            ids[i] = s["input_ids"]

        all_steps = np.arange(0, vlen - seq_len // 2, seq_len // 4)
        steps, active = [], []
        for idx, step in enumerate(all_steps):
            m = self._active_text_mask(idx, step, len(all_steps), vlen, aligned, mid_ts)
            if m is not None and m.sum() > 0:
                row = np.zeros(n_bucket, bool)
                row[:n_text] = m
                steps.append(int(step))
                active.append(row)
        return dict(
            video=video, vlen=vlen, n_text=n_text, n_bucket=n_bucket, ids=ids,
            steps=np.asarray(steps, np.int64),
            active=np.asarray(active, bool).reshape(len(steps), n_bucket),
        )

    def _packed_table(self, corpus: Sequence[Dict], preps: List[Dict]):
        """One device table of the unique videos; row offset per corpus item."""
        keys = [item.get("vid", i) for i, item in enumerate(corpus)]
        uniq: Dict = {}
        for i, k in enumerate(keys):
            uniq.setdefault(k, preps[i]["video"])
        table, uoffs = pack_video_table(list(uniq.values()), self.model.dtype)
        off_of = dict(zip(uniq.keys(), uoffs))
        row_off = torch.tensor([int(off_of[k]) for k in keys], device=self.device)
        return table.to(self.device), row_off

    def _encode_text(self, ids: np.ndarray) -> torch.Tensor:
        ids_t = torch.as_tensor(ids, device=self.device).long()
        return self.model.encode_text(ids_t, (ids_t != 0).int())

    # -------------------------------------------------------------- device side

    def _window_sims(self, wins, win_pad, text, text_pad):
        """Last-layer joint and dual logits [W, T, Nb] and the per-window
        alignability [W, Nb]: the head on joint layer ``a_layer``, else the max
        over in-window time (eval_zeroshot_align.py:186-192)."""
        sims = self.model.text_visual_sims(
            wins, text, video_padding_mask=win_pad, lang_padding_mask=text_pad)
        joint = sims["sim"][:, -1] / TEMPERATURE
        dual = sims["dual-sim"][:, -1] / TEMPERATURE
        if self.use_head:
            a_joint = sims["alignability-joint"][:, self.a_layer, :, 0].float()
        else:
            a_joint = joint.masked_fill(win_pad[:, :, None], -math.inf).amax(dim=1)
        return joint, dual, a_joint

    @torch.inference_mode()
    def evaluate_corpus_batched(self, corpus: Sequence[Dict]) -> List[Dict]:
        """Overlap-seq method.  Returns per-video {'sim' [N, vlen] canvas,
        'align_score' [N]} in corpus order."""
        if not corpus:
            return []
        T, chunk = self.cfg.seq_len, self.cfg.batch_windows
        preps = [self._prepare_video(item) for item in corpus]
        table, row_off = self._packed_table(corpus, preps)
        dev = self.device
        groups: Dict[int, List[int]] = {}
        for i, p in enumerate(preps):
            groups.setdefault(p["n_bucket"], []).append(i)

        results: List[Optional[Dict]] = [None] * len(corpus)
        time_iota = torch.arange(T, device=dev)
        for Nb, idxs in groups.items():
            text = self._encode_text(np.stack([preps[i]["ids"] for i in idxs]))  # [V, Nb, Ct]
            vlens_h = [preps[i]["vlen"] for i in idxs]
            vlens = torch.tensor(vlens_h, device=dev)
            rows0 = row_off[idxs]
            # each video's canvas is its own span of columns of one [Nb, total] canvas
            col0_h = np.concatenate([[0], np.cumsum(vlens_h)[:-1]])
            col0 = torch.as_tensor(col0_h, device=dev)
            total = int(sum(vlens_h))
            # every window of the group, flattened: owner video, start, active set
            win_vid = torch.as_tensor(np.concatenate(
                [np.full(len(preps[i]["steps"]), k) for k, i in enumerate(idxs)]), device=dev)
            steps = torch.as_tensor(np.concatenate([preps[i]["steps"] for i in idxs]), device=dev)
            active = torch.as_tensor(np.concatenate([preps[i]["active"] for i in idxs]),
                                     device=dev)

            canvas_j = torch.zeros(Nb, total, device=dev)
            canvas_d = torch.zeros(Nb, total, device=dev)
            counter = torch.zeros(Nb, total, device=dev)
            a_acc = torch.zeros(len(idxs), Nb, device=dev)
            t_counter = torch.zeros(len(idxs), Nb, device=dev)
            for c0 in range(0, len(steps), chunk):
                vk, act = win_vid[c0:c0 + chunk], active[c0:c0 + chunk]
                vl = vlens[vk][:, None]
                idx = steps[c0:c0 + chunk, None] + time_iota[None]  # [w, T]
                in_range = idx < vl  # true length, not a padded bucket
                # out-of-range rows gather the video's last row; the masks below
                # keep them out of every sum
                t_idx = torch.minimum(idx, vl - 1)
                wins = table[rows0[vk][:, None] + t_idx]  # [w, T, C]
                joint, dual, a_joint = sharded_rows(
                    len(vk), lambda a, b: self._window_sims(
                        wins[a:b], ~in_range[a:b], text[vk[a:b]], ~act[a:b]), self.group)
                wmask = (in_range[:, :, None] & act[:, None, :]).float()  # [w, T, Nb]
                cols = (col0[vk][:, None] + t_idx).reshape(-1)
                to_canvas = lambda x: x.permute(2, 0, 1).reshape(Nb, -1)
                canvas_j.index_add_(1, cols, to_canvas(joint * wmask))
                canvas_d.index_add_(1, cols, to_canvas(dual * wmask))
                counter.index_add_(1, cols, to_canvas(wmask))
                amask = act.float()
                a_acc.index_add_(0, vk, a_joint * amask)
                t_counter.index_add_(0, vk, amask)

            cnt = counter.clamp_min(EPS)
            # the ROC-AUC bugfix norm, then (joint + dual) / 2 (:200-205)
            sim = ((canvas_j / cnt + canvas_d / cnt) / 2.0).cpu().numpy()
            align = (a_acc / t_counter.clamp_min(EPS)).cpu().numpy()
            for k, i in enumerate(idxs):
                n, c, v = preps[i]["n_text"], int(col0_h[k]), preps[i]["vlen"]
                s = sim[:n, c:c + v]
                if self.use_head:
                    a = align[k, :n]
                else:
                    a = np.where(s == 0, MASK_VALUE, s).max(axis=-1)
                results[i] = {"sim": s, "align_score": a}
        return results

    @torch.inference_mode()
    def evaluate_corpus_global(self, corpus: Sequence[Dict]) -> List[Dict]:
        """Global method (eval_zeroshot_align.py:207-216): each whole video in
        one forward, pos-enc interpolated from seq_len to its true length.
        Videos are sorted by length into <= cfg.global_buckets buckets padded
        to round_up(max vlen, 64), text padded to the corpus-max bucket, and
        each bucket runs in calls of up to batch_windows * seq_len tokens."""
        if not corpus:
            return []
        cfg = self.cfg
        preps = [self._prepare_video(item) for item in corpus]
        table, row_off = self._packed_table(corpus, preps)
        dev = self.device
        Nb = max(p["n_bucket"] for p in preps)
        W = preps[0]["ids"].shape[1]
        order = sorted(range(len(corpus)), key=lambda i: preps[i]["vlen"])
        nb = max(1, min(cfg.global_buckets, len(order)))
        buckets = [order[len(order) * j // nb : len(order) * (j + 1) // nb] for j in range(nb)]

        results: List[Optional[Dict]] = [None] * len(corpus)
        for bidxs in buckets:
            if not bidxs:
                continue
            Tb = _round_up(max(preps[i]["vlen"] for i in bidxs), 64)
            per_call = max(1, cfg.batch_windows * cfg.seq_len // Tb)
            len_iota = torch.arange(Tb, device=dev)
            for c0 in range(0, len(bidxs), per_call):
                take = bidxs[c0:c0 + per_call]
                ids = np.zeros((len(take), Nb, W), np.int32)
                tpad = np.ones((len(take), Nb), bool)
                for k, i in enumerate(take):
                    ids[k, : preps[i]["n_bucket"]] = preps[i]["ids"]
                    tpad[k, : preps[i]["n_text"]] = False
                text = self._encode_text(ids)
                vlens = torch.tensor([preps[i]["vlen"] for i in take], device=dev)
                in_range = len_iota[None] < vlens[:, None]  # [V, Tb]
                rows = row_off[take][:, None] + torch.minimum(len_iota[None], vlens[:, None] - 1)
                tpad_d = torch.as_tensor(tpad, device=dev)

                def run(a, b):
                    # the joint encoder only: the global method reads no dual sim
                    sims = self.model.text_visual_sims(
                        table[rows[a:b]], text[a:b], ~in_range[a:b], tpad_d[a:b],
                        interpolate_from=cfg.seq_len, effective_len=vlens[a:b], dual=False)
                    joint = sims["sim"][:, -1] / TEMPERATURE  # [V, Tb, Nb]
                    if self.use_head:
                        return joint, sims["alignability-joint"][:, -1, :, 0].float()
                    return joint, joint.masked_fill(~in_range[a:b, :, None],
                                                    -math.inf).amax(dim=1)

                joint, a_joint = sharded_rows(len(take), run, self.group)
                joint, a_joint = joint.cpu().numpy(), a_joint.cpu().numpy()
                for k, i in enumerate(take):
                    n, v = preps[i]["n_text"], preps[i]["vlen"]
                    results[i] = {"sim": joint[k, :v, :n].T, "align_score": a_joint[k, :n]}
        return results

    def evaluate_corpus(self, corpus: Sequence[Dict]) -> List[Dict]:
        """Per-video {'sim', 'align_score'} by ``cfg.method``."""
        if self.cfg.method == "global":
            return self.evaluate_corpus_global(corpus)
        return self.evaluate_corpus_batched(corpus)

    def evaluate_video(self, item: Dict) -> Dict[str, np.ndarray]:
        """Returns {'sim': [N, vlen] canvas, 'align_score': [N]}."""
        return self.evaluate_corpus([item])[0]

    def evaluate(self, corpus: Sequence[Dict]) -> Dict[str, float]:
        """Full-corpus Recall and ROC-AUC (eval_zeroshot_align.py:222-250)."""
        corpus = list(corpus)
        return alignment_metrics(corpus, self.evaluate_corpus(corpus))


def alignment_metrics(corpus: Sequence[Dict], per_video: Sequence[Dict]) -> Dict[str, float]:
    """Recall: R@1 of the canvas argmax over alignable sentences (inside
    [floor(start), ceil(end)]); AUC: ROC-AUC of align_score against
    alignability (eval_zeroshot_align.py:222-250)."""
    recall = []
    all_scores, all_tgts = [], []
    for item, res in zip(corpus, per_video):
        sents = item["sentences"]
        aligned = np.array([s["aligned"] for s in sents]).astype(bool)
        all_scores.append(res["align_score"])
        all_tgts.append(aligned.astype(int))
        masked = np.where(res["sim"] == 0, MASK_VALUE, res["sim"])
        for i in np.nonzero(aligned)[0]:
            s = math.floor(sents[i]["start"])
            e = math.ceil(sents[i]["end"])
            recall.append(s <= int(masked[i].argmax()) <= e)
    auc = roc_auc_score(np.concatenate(all_tgts), np.concatenate(all_scores))
    return {"Recall": float(np.mean(recall)), "AUC": auc}


def test_alignment(model: torch.nn.Module, corpus: Sequence[Dict],
                   cfg: Optional[EvalConfig] = None) -> Dict[str, float]:
    """Functional entry mirroring test_alignment_htm (eval_zeroshot_align.py:97):
    Recall and AUC of ``model`` (which carries its weights) on ``corpus``."""
    return AlignmentEvaluator(model, cfg or EvalConfig()).evaluate(corpus)
