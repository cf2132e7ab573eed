"""Host data-pipeline throughput bench: can the loader feed the card's step?
(counterpart of temporalalignnet_tpu/tools/bench_loader.py)

The train-step bench (``tools/bench_train_step.py``) measures the device side
of a step on a synthetic batch already on the card; this measures the host
side: the real ``HTMFeatureDataset.sample`` -> ``stack_samples`` ->
``TrainLoader`` path on a synthetic on-disk corpus at reference scale (vlen
~400 s videos, ~60 captions each, 512-d features: the htm-370k shape).

Prints samples/s and batches/s per worker count, and how many times that
rate a given device demand needs (``--target_sps``; by default the graphed
Stage-1 step on an H100).  The reference's equivalent knob is the torch
DataLoader's ``num_workers`` (train/main.py:218-227); here workers are
threads in one process (numpy releases the GIL for the memmap reads and
stacking), so one host's scaling tops out at its core count, and
multi-process feeding shards rows per process instead
(``data/prefetch.py``'s ``local_rows``).  Runs on the host only.

``--metadata N``: the dataset's start-up at reference metadata scale (the
monolithic caption json against the indexed .jsonl store, each in a fresh
process).  ``--vlen_files N``: ``build_vlen_table``'s cost per feature file.

Usage:  python -m temporalalignnet_torch.tools.bench_loader [--batch_size 64]
        [--workers 1,2,4,8] [--videos 80] [--batches 40] [--target_sps 3755]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from temporalalignnet_torch.core.config import DataConfig
from temporalalignnet_torch.data.htm import HTMFeatureDataset
from temporalalignnet_torch.data.prefetch import TrainLoader
from temporalalignnet_torch.models.word2vec import Word2VecTokenizer

WORDS = [f"word{i}" for i in range(600)]

# the graphed Stage-1 train step (E6D6, B = 64, bf16, fused MIL-NCE,
# --steps_per_dispatch 4) on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit: 58.67 steps/s (PERF.md section 5)
CARD_STEPS_PER_S = 58.67
CARD_BATCH = 64


def build_corpus(
    root: str, n_videos: int, rng: np.random.RandomState
) -> "tuple[str, str]":
    """Reference-scale synthetic corpus: {vid}.mp4.npy + captions json.

    Returns (feature_dir, captions_json_path)."""
    feat_dir = os.path.join(root, "features")
    os.makedirs(feat_dir, exist_ok=True)
    captions = {}
    for i in range(n_videos):
        vid = f"v{i:04d}"
        vlen = int(rng.randint(300, 500))  # ~400 s @ 1 feature/s
        np.save(
            os.path.join(feat_dir, vid + ".mp4.npy"),
            rng.randn(vlen, 512).astype(np.float16),
        )
        n_caps = int(rng.randint(40, 80))
        bounds = np.sort(rng.uniform(2, vlen - 2, n_caps + 1))
        captions[vid] = {
            "text": [
                " ".join(rng.choice(WORDS, rng.randint(4, 14)))
                for _ in range(n_caps)
            ],
            "start": bounds[:-1].tolist(),
            "end": bounds[1:].tolist(),
        }
    cap_path = os.path.join(root, "captions.json")
    with open(cap_path, "w") as f:
        json.dump(captions, f)
    return feat_dir, cap_path


def build_metadata_corpus(root: str, n_videos: int, rng: np.random.RandomState):
    """Reference-scale caption METADATA only (no feature files): the
    monolithic dict json (sentencified_htm_370k.json layout,
    loader_htm.py:81-84) written streaming, plus a matching vlen csv.

    Returns (json_path, vlen_csv_path)."""
    import csv as _csv

    # realistic density: ~40-80 captions/video, 4-14 words each; texts come
    # from a pre-built pool so GENERATION isn't the bottleneck — parse cost
    # depends on bytes/structure, not string novelty
    pool = [
        " ".join(rng.choice(WORDS, rng.randint(4, 14))) for _ in range(2048)
    ]
    cap_path = os.path.join(root, "captions_full.json")
    vlen_path = os.path.join(root, "htm_vlen.csv")
    with open(cap_path, "w") as f, open(vlen_path, "w", newline="") as vf:
        w = _csv.writer(vf)
        w.writerow(["vid", "vlen"])
        f.write("{")
        for i in range(n_videos):
            vid = f"v{i:06d}"
            vlen = int(rng.randint(300, 500))
            w.writerow([vid, vlen])
            n_caps = int(rng.randint(40, 80))
            bounds = np.round(np.sort(rng.uniform(2, vlen - 2, n_caps + 1)), 2)
            rec = {
                "text": [pool[j] for j in rng.randint(0, len(pool), n_caps)],
                "start": bounds[:-1].tolist(),
                "end": bounds[1:].tolist(),
            }
            if i:
                f.write(",")
            f.write(json.dumps(vid) + ":" + json.dumps(rec))
        f.write("}")
    return cap_path, vlen_path


_CHILD_INIT = r"""
import json, resource, sys, time
cap_path, vlen_path = sys.argv[1], sys.argv[2]
t0 = time.perf_counter()
from temporalalignnet_torch.data.htm import HTMFeatureDataset, load_vlen_table
import_s = time.perf_counter() - t0
rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
vlen = load_vlen_table(vlen_path)
t1 = time.perf_counter()
ds = HTMFeatureDataset("/nonexistent", cap_path, vlen_table=vlen,
                       min_vlen=64, max_vlen=1000)
init_s = time.perf_counter() - t1
rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(json.dumps({"import_s": import_s, "init_s": init_s,
                  "rss0_mb": rss0 / 1024, "rss_mb": rss1 / 1024,
                  "train_videos": len(ds)}))
"""


def run_metadata_bench(n_videos: int) -> None:
    """Measure HTMFeatureDataset STARTUP at reference metadata scale: the
    monolithic json.load path vs the offset-indexed .jsonl store, each in a
    fresh subprocess so peak RSS is attributable (rss0 = the baseline after
    importing the port's data module, torch included; rss_mb - rss0_mb =
    the metadata cost)."""
    import subprocess
    import sys

    from temporalalignnet_torch.tools.convert_captions import convert

    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        cap_json, vlen_csv = build_metadata_corpus(root, n_videos, rng)
        gen_s = time.perf_counter() - t0
        size_mb = os.path.getsize(cap_json) / 1e6
        print(f"corpus metadata: {n_videos} videos, {size_mb:,.0f} MB json "
              f"(generated in {gen_s:,.0f} s)")

        t0 = time.perf_counter()
        cap_jsonl = os.path.join(root, "captions_full.jsonl")
        n = convert(cap_json, cap_jsonl)
        conv_s = time.perf_counter() - t0
        assert n == n_videos
        print(f"convert_captions (one-time, streaming): {conv_s:,.1f} s")

        # the child must resolve the package whatever the caller's cwd;
        # APPEND the repo root to PYTHONPATH, never replace what is there
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = ":".join(
            x for x in (env.get("PYTHONPATH"), repo_root) if x
        )
        for label, path in (("monolithic json.load", cap_json),
                            ("indexed .jsonl store", cap_jsonl)):
            r = subprocess.run(
                [sys.executable, "-c", _CHILD_INIT, path, vlen_csv],
                capture_output=True, text=True, env=env,
            )
            if r.returncode != 0:
                raise SystemExit(f"{label} child failed:\n{r.stderr[-2000:]}")
            d = json.loads(r.stdout.strip().splitlines()[-1])
            print(
                f"{label}: init {d['init_s']:,.1f} s, "
                f"peak RSS {d['rss_mb']:,.0f} MB "
                f"(+{d['rss_mb'] - d['rss0_mb']:,.0f} MB over the "
                f"{d['rss0_mb']:,.0f} MB baseline after importing the port's "
                f"data module and torch; {d['train_videos']} train videos)"
            )


def run_vlen_stat_bench(n_files: int) -> None:
    """Per-file cost of build_vlen_table's serial header-stat pass (the
    one-time fallback when data/htm_vlen.csv is absent; result is cached)."""
    from temporalalignnet_torch.data.htm import build_vlen_table

    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as root:
        vids = [f"s{i:06d}" for i in range(n_files)]
        for v in vids:
            np.save(os.path.join(root, v + ".mp4.npy"),
                    np.zeros((int(rng.randint(300, 500)), 4), np.float16))
        t0 = time.perf_counter()
        table = build_vlen_table(root, vids, cache_path=None)
        dt = time.perf_counter() - t0
        assert len(table) == n_files
        per = dt / n_files * 1e3
        print(f"build_vlen_table: {n_files} files in {dt:,.1f} s "
              f"({per:.2f} ms/file -> ~{per * 370_000 / 1e3 / 60:,.0f} min at "
              f"370k, one-time, cached to csv)")


def make_dataset(feat_dir: str, cap_path: str, cache_videos: int) -> HTMFeatureDataset:
    """The train split of ``build_corpus``'s corpus, tokenized over WORDS."""
    cfg = DataConfig()
    tok = Word2VecTokenizer(WORDS, max_words=cfg.max_words)
    return HTMFeatureDataset(feat_dir, cap_path, cfg, "train", tok, cache_videos=cache_videos)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--videos", type=int, default=80)
    p.add_argument("--batches", type=int, default=40)
    p.add_argument("--workers", default="1,2,4")
    p.add_argument(
        "--metadata", type=int, default=0,
        help="metadata-startup mode: synthesize N caption entries (no feature "
        "files), measure dataset-init wall/RSS for monolithic json vs the "
        "indexed .jsonl store, then exit (try 370000)",
    )
    p.add_argument(
        "--vlen_files", type=int, default=0,
        help="measure build_vlen_table's per-file stat cost over N synthetic "
        "feature files, then exit",
    )
    p.add_argument(
        "--cache_videos", type=int, default=256,
        help="per-video host cache size (0 = reference-style reload/retokenize)",
    )
    p.add_argument(
        "--target_sps", type=float, default=CARD_STEPS_PER_S * CARD_BATCH,
        help="device demand in samples/s to size cores against (default: the "
        "graphed Stage-1 step, 58.67 steps/s * B=64, measured by chip_smoke.py "
        "on an NVIDIA H100 80GB HBM3 at a 700 W power limit; PERF.md section 5)",
    )
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    if args.metadata:
        run_metadata_bench(args.metadata)
        return
    if args.vlen_files:
        run_vlen_stat_bench(args.vlen_files)
        return

    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as root:
        feat_dir, cap_path = build_corpus(root, args.videos, rng)
        ds = make_dataset(feat_dir, cap_path, args.cache_videos)
        print(f"corpus: {len(ds)} samples over {args.videos} videos")
        if len(ds) < args.batch_size:
            raise SystemExit(
                f"corpus too small: {len(ds)} samples < batch_size "
                f"{args.batch_size} and drop_last leaves zero batches — "
                "raise --videos or lower --batch_size"
            )

        for w in [int(x) for x in args.workers.split(",")]:
            loader = TrainLoader(ds, batch_size=args.batch_size, seed=0,
                                 num_workers=w, prefetch=2)
            # warm one batch (thread pool spin-up, page cache); an epoch is
            # one window per video (reference semantics), so loop epochs
            # until enough batches are timed.  Close the warm-up iterator
            # explicitly so its producer stops before the timed loop starts
            # (otherwise it may race one extra batch on the shared pool).
            it = iter(loader)
            next(it)
            it.close()
            t0 = time.perf_counter()
            n, epoch = 0, 0
            while n < args.batches * args.batch_size:
                loader.set_epoch(epoch)
                for batch in loader:
                    n += batch["video"].shape[0]
                    if n >= args.batches * args.batch_size:
                        break
                epoch += 1
            dt = time.perf_counter() - t0
            sps = n / dt
            print(
                f"workers={w}: {sps:,.0f} samples/s "
                f"({sps / args.batch_size:.1f} batches/s at B={args.batch_size}; "
                f"feeding {args.target_sps:,.0f} samples/s needs "
                f"~{max(1.0, args.target_sps / sps):.1f}x this)"
            )


if __name__ == "__main__":
    main()
