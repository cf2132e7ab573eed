"""Caption filters for the offline sentencify pipeline (the port's copy of
temporalalignnet_tpu/tools/filters.py, which imports nothing of JAX; the
port keeps its own).

Ports of reference sentencify_text/filters/utils.py:
- merge_linebreaks (utils.py:44-132): drop <0.2 s glitches, strip [MUSIC]-style
  brackets, collapse YouTube's rolling-two-line repetition (both the linebreak
  form and the 3x startswith form), average overlapping timestamps;
- filter_length (utils.py:36-41): >10 captions and mean >5 words;
- filter_language (utils.py:7-33): avg P(en) > 0.9 over 5 sampled captions via
  langdetect when installed; otherwise a stopword-ratio heuristic stands in
  (this image has no langdetect — the API and threshold semantics are kept).
"""

from __future__ import annotations

import random
import re
from typing import List, Sequence, Tuple

import numpy as np

try:
    from langdetect import DetectorFactory, detect_langs

    DetectorFactory.seed = 0
    _HAVE_LANGDETECT = True
except ImportError:
    _HAVE_LANGDETECT = False

# high-frequency English function words for the fallback detector
_EN_STOPWORDS = frozenset(
    "the a an and or but if of to in on at is are was were be been being have has "
    "had do does did will would can could should this that these those it its you "
    "your we our they their he she his her i my me so not no with for from as by "
    "what when where how why which who whom there here then than just about going "
    "go get got make made let very really some any all more most now out up down".split()
)


def _english_prob(text: str) -> float:
    if _HAVE_LANGDETECT:
        try:
            langs = detect_langs(text)
        except Exception:  # all numbers / symbols
            return -1.0
        return {l.lang: l.prob for l in langs}.get("en", 0.0)
    words = re.findall(r"[a-z']+", text.lower())
    if not words:
        return -1.0
    ratio = sum(w in _EN_STOPWORDS for w in words) / len(words)
    # stopword ratio ~0.4-0.6 for English prose; scale to a pseudo-probability
    return min(ratio / 0.35, 1.0)


def filter_language(cap_list: Sequence[str], rng: random.Random = None) -> bool:
    """True if avg P(en) over <=5 sampled captions (>=4 words) exceeds 0.9."""
    r = rng or random
    caps = list(map(str, cap_list))
    try:
        subset = r.sample(caps, 5)
    except ValueError:
        subset = caps
    subset = [c for c in subset if len(c.split()) >= 4]
    probs = [p for p in (_english_prob(c) for c in subset) if p >= 0]
    return bool(probs) and float(np.mean(probs)) > 0.9


def filter_length(cap_list: Sequence[str]) -> bool:
    caps = [str(i) for i in cap_list]
    num_word = [len(c.split(" ")) for c in caps]
    return len(caps) > 10 and float(np.mean(num_word)) > 5


def merge_linebreaks(
    cap_list: Sequence[str],
    start_list: Sequence[float],
    end_list: Sequence[float],
) -> Tuple[List[str], List[float], List[float]]:
    assert len(cap_list) == len(start_list) == len(end_list)

    # remove caption glitches (< 0.2 s)
    keep = (np.asarray(end_list, float) - np.asarray(start_list, float)) > 0.2
    caps = [c for c, k in zip(cap_list, keep) if k]
    starts = [s for s, k in zip(start_list, keep) if k]
    ends = [e for e, k in zip(end_list, keep) if k]

    caps_tmp, starts_tmp, ends_tmp = [], [], []
    n = len(caps)
    for idx in range(n):
        cap = str(caps[idx]).strip()
        if not cap:
            continue
        if "[" in cap and "]" in cap:  # e.g. [MUSIC]
            continue
        if "\n" in cap:
            # rolling two-line captions: if our last row is repeated as the
            # next caption's first row, drop it here
            if (
                idx + 1 < n
                and str(caps[idx + 1]).strip().split("\n")[0].strip()
                == cap.split("\n")[-1].strip()
            ):
                new_cap = " ".join(cap.split("\n")[:-1])
            else:
                new_cap = cap.replace("\n", " ")
        else:
            new_cap = cap
        caps_tmp.append(new_cap)
        starts_tmp.append(starts[idx])
        ends_tmp.append(ends[idx])

    # second-round dedup: some text repeats 3x via startswith-growth
    dup = [
        1.0 if (len(b) >= len(a) and b.startswith(a)) else 0.0
        for a, b in zip(caps_tmp[:-1], caps_tmp[1:])
    ]
    if sum(dup) > 0:
        caps_o, starts_o, ends_o = [], [], []
        m = len(caps_tmp)
        for idx in range(m - 1):
            cap = str(caps_tmp[idx]).strip()
            if dup[idx] == 1:
                if idx > 0 and dup[idx - 1] == 1:
                    continue
                starts_o.append(starts_tmp[idx])
            else:
                if idx > 0 and dup[idx - 1] == 1:
                    ends_o.append(ends_tmp[idx])
                    caps_o.append(cap)
                else:
                    starts_o.append(starts_tmp[idx])
                    ends_o.append(ends_tmp[idx])
                    caps_o.append(cap)
        if dup[-1] == 0:
            starts_o.append(starts_tmp[-1])
        ends_o.append(ends_tmp[-1])
        caps_o.append(caps_tmp[-1])
        assert len(caps_o) == len(starts_o) == len(ends_o)
        caps_tmp, starts_tmp, ends_tmp = caps_o, starts_o, ends_o

    # average overlapping timestamps
    if len(caps_tmp) > 1:
        starts_a = np.asarray(starts_tmp, float)
        ends_a = np.asarray(ends_tmp, float)
        overlap = starts_a[1:] - ends_a[:-1] < 0
        if overlap.sum() > 0:
            avg = np.stack([starts_a[1:], ends_a[:-1]]).mean(0)
            starts_a[1:][overlap] = avg[overlap]
            ends_a[:-1][overlap] = avg[overlap]
            assert ((starts_a[1:] - ends_a[:-1]) < 0).sum() == 0
            starts_tmp, ends_tmp = starts_a.tolist(), ends_a.tolist()

    return caps_tmp, starts_tmp, ends_tmp
