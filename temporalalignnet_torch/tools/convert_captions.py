"""Convert a monolithic caption JSON to the indexed .jsonl layout — streaming
(the port's copy of temporalalignnet_tpu/tools/convert_captions.py; the
output is byte-equal).

The reference's caption metadata is ONE json dict over the whole corpus
(``sentencified_htm_370k.json``: {vid: {"text": [...], "start": [...],
"end": [...]}}, reference data/loader_htm.py:81-84).  Parsing it eagerly at
370k-video scale costs minutes of single-core time and a multi-GB Python
object tree before training step 0.  This tool rewrites it once into one
JSON record per line with ``vid`` as the first key:

    {"vid": "abc123", "text": [...], "start": [...], "end": [...]}

which ``data/htm.py::JsonlCaptionStore`` indexes by byte offset in a single
sequential scan (no JSON parse at startup, RSS = the vid->offset index).

The conversion itself NEVER materializes the input dict: a buffered
incremental parser walks the top-level object one (key, value) pair at a
time with bounded memory, so it runs on hosts that could not hold the
eager parse at all.

Usage:  python -m temporalalignnet_torch.tools.convert_captions \
            sentencified_htm_370k.json [out.jsonl]
"""

from __future__ import annotations

import argparse
import json
from typing import IO, Iterator, Optional, Tuple

_CHUNK = 1 << 20  # 1 MB refills


class _Stream:
    """A sliding window over a text file supporting incremental raw_decode."""

    def __init__(self, f: IO[str]):
        self._f = f
        self.buf = ""
        self.pos = 0

    def _refill(self) -> bool:
        chunk = self._f.read(_CHUNK)
        if not chunk:
            return False
        # compact: drop consumed prefix so the window stays ~value-sized
        if self.pos:
            self.buf = self.buf[self.pos:]
            self.pos = 0
        self.buf += chunk
        return True

    def skip_ws(self) -> str:
        """Advance past whitespace; return the next char (refilling as needed)."""
        while True:
            while self.pos < len(self.buf) and self.buf[self.pos] in " \t\r\n":
                self.pos += 1
            if self.pos < len(self.buf):
                return self.buf[self.pos]
            if not self._refill():
                raise ValueError("unexpected end of JSON input")

    def expect(self, ch: str) -> None:
        got = self.skip_ws()
        if got != ch:
            raise ValueError(f"expected {ch!r}, found {got!r} at offset ~{self.pos}")
        self.pos += 1

    def decode_value(self, dec: json.JSONDecoder):
        """raw_decode one JSON value at pos, refilling until it completes."""
        self.skip_ws()
        while True:
            try:
                val, end = dec.raw_decode(self.buf, self.pos)
            except ValueError:
                if not self._refill():
                    raise
                continue
            # a value ending exactly at the buffer edge may be a PREFIX of a
            # longer token (e.g. number '12' of '123'); refill once to be sure
            if end == len(self.buf) and self._refill():
                continue
            self.pos = end
            return val


def iter_json_object(f: IO[str]) -> Iterator[Tuple[str, object]]:
    """Yield the (key, value) pairs of a top-level JSON object incrementally.

    Bounded memory: the window holds ~one value (one video's captions) plus
    the 1 MB refill chunk.
    """
    dec = json.JSONDecoder()
    s = _Stream(f)
    s.expect("{")
    if s.skip_ws() == "}":
        return
    while True:
        key = s.decode_value(dec)
        if not isinstance(key, str):
            raise ValueError(f"object key is not a string: {key!r}")
        s.expect(":")
        yield key, s.decode_value(dec)
        nxt = s.skip_ws()
        s.pos += 1
        if nxt == "}":
            return
        if nxt != ",":
            raise ValueError(f"expected ',' or '}}', found {nxt!r}")


def convert(src: str, dst: str) -> int:
    """Stream-convert ``src`` (monolithic dict) to ``dst`` (.jsonl).  Returns
    the number of videos written."""
    n = 0
    with open(src, encoding="utf-8") as f, open(dst, "w", encoding="utf-8") as out:
        for vid, rec in iter_json_object(f):
            if isinstance(rec, str):  # htm-fe layout: vid -> per-video csv path
                line = {"vid": vid, "path": rec}
            else:
                line = {"vid": vid, **rec}
            out.write(json.dumps(line, ensure_ascii=False) + "\n")
            n += 1
    return n


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("src", help="monolithic caption json (e.g. sentencified_htm_370k.json)")
    p.add_argument("dst", nargs="?", default=None,
                   help="output .jsonl (default: src with .jsonl suffix)")
    args = p.parse_args(argv)
    dst: Optional[str] = args.dst
    if dst is None:
        dst = args.src[: -len(".json")] + ".jsonl" if args.src.endswith(".json") \
            else args.src + ".jsonl"
    n = convert(args.src, dst)
    print(f"wrote {n} video records to {dst}")


if __name__ == "__main__":
    main()
