"""3-step HowTo100M caption pipeline (counterpart of
temporalalignnet_tpu/tools/process_htm.py; reference
sentencify_text/process_htm.py:71-156).

Step 1: split the giant raw-caption json into N chunks        (:74-94)
Step 2: parallel language+length filtering                    (:96-122)
Step 3: merge linebreaks + sentencify -> per-chunk jsons      (:124-156)

Usage:
  python -m temporalalignnet_torch.tools.process_htm \\
      --raw_caption raw_caption.json --out_dir out/ \\
      --punct_model_dir bert-restore-punctuation/ [--num_chunks 8] [--jobs 16] \\
      [--device cuda]

Input format: {vid: {"text": [...], "start": [...], "end": [...]}}.
Without --punct_model_dir only the already-punctuated skip-path is available.
With it the punctuator (``sentencify.HFPunctuator``, the port's BERT) runs
on ``--device`` (default the card; ``cpu`` for the CPU); the filter step's
process pool stays on the host.  The files written are the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Optional

from temporalalignnet_torch.tools.filters import (
    filter_language,
    filter_length,
    merge_linebreaks,
)


def split_chunks(raw_caption_path: str, out_dir: str, num_chunks: int = 8) -> list:
    with open(raw_caption_path) as f:
        raw = json.load(f)
    vids = sorted(raw.keys())
    paths = []
    os.makedirs(out_dir, exist_ok=True)
    per = (len(vids) + num_chunks - 1) // num_chunks
    for i in range(num_chunks):
        part = {v: raw[v] for v in vids[i * per : (i + 1) * per]}
        p = os.path.join(out_dir, f"raw_chunk_{i}.json")
        with open(p, "w") as f:
            json.dump(part, f)
        paths.append(p)
    return paths


def _vid_passes(item) -> bool:
    caps = [str(t) for t in item["text"]]
    return filter_length(caps) and filter_language(caps)


def filter_chunk(chunk_path: str) -> str:
    with open(chunk_path) as f:
        chunk = json.load(f)
    kept = {v: it for v, it in chunk.items() if _vid_passes(it)}
    out = chunk_path.replace("raw_chunk", "filtered_chunk")
    with open(out, "w") as f:
        json.dump(kept, f)
    return out


def filter_chunks(paths, jobs: int = 8) -> list:
    # spawned workers: the caller may hold threads and a CUDA context, which
    # fork would copy half-made
    with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(filter_chunk, paths))


def _prepare_chunk(chunk_path: str) -> list:
    """Host-side regrouping for one chunk: load + merge_linebreaks per video.
    Pure CPU/IO — safe to run ahead of the punctuator."""
    with open(chunk_path) as f:
        chunk = json.load(f)
    prepared = []
    for vid, item in chunk.items():
        caps, starts, ends = merge_linebreaks(
            item["text"], item["start"], item["end"]
        )
        if caps:
            prepared.append((vid, caps, starts, ends))
    return prepared


def _punctuate_prepared(prepared: list, sentencifier, chunk_path: str) -> str:
    out_dict: Dict[str, Dict] = {}
    for vid, caps, starts, ends in prepared:
        caps, starts, ends = sentencifier.punctuate_and_cut(caps, starts, ends)
        out_dict[vid] = {"text": caps, "start": starts, "end": ends}
    out = chunk_path.replace("filtered_chunk", "sentencified_chunk")
    with open(out, "w") as f:
        json.dump(out_dict, f)
    return out


def sentencify_chunk(chunk_path: str, sentencifier) -> str:
    return _punctuate_prepared(_prepare_chunk(chunk_path), sentencifier, chunk_path)


def sentencify_chunks(paths, sentencifier, prefetch: int = 2) -> list:
    """Step 3 with pipelining: while the punctuator model runs on chunk i, a
    thread pool loads + regroups chunks i+1..i+prefetch.  This is the
    port's equivalent of the reference overlapping host regrouping with
    BERT inference via DataLoader workers
    (sentencify_text/process_htm.py:124-156)."""
    from concurrent.futures import ThreadPoolExecutor

    prefetch = max(prefetch, 1)
    outs = []
    # futures key by position, not path: duplicate paths stay distinct entries
    with ThreadPoolExecutor(max_workers=prefetch) as pool:
        futures = {
            i: pool.submit(_prepare_chunk, p) for i, p in enumerate(paths[:prefetch])
        }
        for i, path in enumerate(paths):
            for j in range(i + 1, min(i + 1 + prefetch, len(paths))):
                if j not in futures:
                    futures[j] = pool.submit(_prepare_chunk, paths[j])
            prepared = futures.pop(i).result()
            outs.append(_punctuate_prepared(prepared, sentencifier, path))
    return outs


def main(argv=None):
    p = argparse.ArgumentParser("HTM caption pipeline")
    p.add_argument("--raw_caption", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--num_chunks", type=int, default=8)
    p.add_argument("--jobs", type=int, default=8)
    p.add_argument("--punct_model_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="the punctuator's device: cuda (default) or cpu")
    args = p.parse_args(argv)

    chunks = split_chunks(args.raw_caption, args.out_dir, args.num_chunks)
    print(f"step 1: {len(chunks)} chunks")
    filtered = filter_chunks(chunks, args.jobs)
    print("step 2: filtered")

    from temporalalignnet_torch.tools.sentencify import HFPunctuator, Sentencify

    if args.punct_model_dir:
        sent = Sentencify(HFPunctuator(args.punct_model_dir, device=args.device))
    else:
        # skip-path only: captions must already carry punctuation
        class _NoPunct:
            def tokenize(self, text):
                raise RuntimeError(
                    "--punct_model_dir required for unpunctuated captions"
                )

            convert_tokens_to_ids = predict = tokenize

        sent = Sentencify(_NoPunct())
    outs = sentencify_chunks(filtered, sent, prefetch=min(args.jobs, 4))
    print(f"step 3: wrote {outs}")
    return outs


if __name__ == "__main__":
    main()
