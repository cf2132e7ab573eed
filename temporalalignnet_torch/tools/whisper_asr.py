"""WhisperX ASR pipeline (reference htm_zoo/whisperx/*) — dependency-gated port
(counterpart of temporalalignnet_tpu/tools/whisper_asr.py).

Three stages, same artifacts as the reference:
1. ``detect_languages``: per-audio language id from the first 30 s log-mels
   (language_detect.py:51-74) -> csv [filename, language, prob];
2. ``transcribe_en``: EN transcription + phoneme alignment -> per-video json
   with word timestamps (transcribe_or_translate.py:72-109), resumable via
   existing-output drop lists;
3. ``translate_non_en``: native-language transcribe+align then M2M100 batch
   translation to EN with sentence-wise timestamps, whisper end-to-end
   translate as fallback (transcribe_or_translate.py:112-202).

whisperx (and its model downloads) may be absent — every entry point is
import-gated with a clear error, and the pure logic (batch_translate
chunking, drop-list resume filtering) is factored out so it is unit-testable
without the models.  The port imports no ``transformers``: stage 3 takes the
M2M100 model and a per-language tokenizer factory from its caller
(``translator``, ``tokenizer_for``), where the JAX package loads them from
``m2m100_dir`` itself.
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Callable, Dict, List, Optional, Sequence


def _require_whisperx():
    try:
        import whisperx  # noqa: F401

        return whisperx
    except ImportError as e:
        raise ImportError(
            "whisperx is required for ASR; install it and download the faster-"
            "whisper large-v2 weights (the reference pipeline's dependency, "
            "htm_zoo/whisperx/readme.md)"
        ) from e


def remaining_after_drop_list(todo_paths: Sequence[str], output_dir: str) -> List[str]:
    """Resume filter: drop inputs whose output json already exists
    (transcribe_or_translate.py:85-89)."""
    done = {
        os.path.basename(p).split(".")[0]
        for p in glob.glob(os.path.join(output_dir, "*.json"))
    }
    return [p for p in todo_paths if os.path.basename(p).split(".")[0] not in done]


def chunk_for_translation(sentences: Sequence[str], batch_size: int = 4) -> List[List[str]]:
    """np.array_split-equivalent chunking (transcribe_or_translate.py:113-115)."""
    import numpy as np

    if not sentences:
        return []
    return [c.tolist() for c in
            np.array_split(np.asarray(sentences, object),
                           len(sentences) // batch_size + 1)]


def batch_translate(model, tokenizer, sentences: Sequence[str],
                    batch_size: int = 4) -> List[str]:
    """M2M100 batched translation to EN (transcribe_or_translate.py:112-121).
    ``model``/``tokenizer`` are HF M2M100 objects (caller loads from a local
    directory — no egress here)."""
    out: List[str] = []
    for batch in chunk_for_translation(sentences, batch_size):
        enc = tokenizer(batch, return_tensors="pt", padding=True)
        tokens = model.generate(
            **enc, forced_bos_token_id=tokenizer.get_lang_id("en")
        )
        out.extend(tokenizer.batch_decode(tokens, skip_special_tokens=True))
    return out


def detect_languages(audio_paths: Sequence[str], output_csv: str,
                     model=None, batch_size: int = 32) -> str:
    """Stage 1: language-id csv.  Skips if the output exists (resume)."""
    if os.path.exists(output_csv):
        return output_csv
    whisperx = _require_whisperx()
    import numpy as np

    model = model or whisperx.load_model("large-v2", device="cpu")
    rows = []
    N_SAMPLES = 30 * 16000
    for path in audio_paths:
        audio = whisperx.load_audio(path)[:N_SAMPLES]
        if audio.shape[0] < N_SAMPLES:
            audio = np.concatenate([audio, np.zeros(N_SAMPLES - audio.shape[0])])
        mel = whisperx.audio.log_mel_spectrogram(audio.astype(np.float32))
        enc = model.model.encode(mel[None])
        (lang_token, prob), *_ = model.model.model.detect_language(enc)[0]
        rows.append([path, lang_token[2:-2], prob])
    os.makedirs(os.path.dirname(os.path.abspath(output_csv)), exist_ok=True)
    with open(output_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "language", "prob"])
        w.writerows(rows)
    return output_csv


def transcribe_en(audio_paths: Sequence[str], output_dir: str,
                  batch_size: int = 16) -> List[str]:
    """Stage 2: EN transcribe + phoneme alignment, one json per audio."""
    whisperx = _require_whisperx()
    os.makedirs(output_dir, exist_ok=True)
    todo = remaining_after_drop_list(audio_paths, output_dir)
    model = whisperx.load_model("large-v2", device="cpu")
    model_a, metadata = whisperx.load_align_model(language_code="en", device="cpu")
    writer = whisperx.utils.get_writer("json", output_dir)
    done = []
    for path in todo:
        audio = whisperx.load_audio(path)
        result = model.transcribe(audio, batch_size=batch_size, language="en")
        result = whisperx.align(result["segments"], model_a, metadata, audio,
                                "cpu", return_char_alignments=False)
        writer(result, path, {"highlight_words": False,
                              "max_line_count": None, "max_line_width": None})
        done.append(path)
    return done


def translate_non_en(audio_paths_by_lang: Dict[str, List[str]], output_dir: str,
                     m2m100_dir: str, batch_size: int = 16, translator=None,
                     tokenizer_for: Optional[Callable[[str, str], object]] = None) -> List[str]:
    """Stage 3: native transcribe+align then M2M100 translation; whisper
    end-to-end translate when no phoneme align model exists for the language.
    ``translator`` is the M2M100 model of ``m2m100_dir`` and
    ``tokenizer_for(m2m100_dir, lang)`` its tokenizer for a source language
    (HF's ``M2M100ForConditionalGeneration`` / ``M2M100Tokenizer``, loaded by
    the caller: the port imports no ``transformers``)."""
    whisperx = _require_whisperx()
    if translator is None or tokenizer_for is None:
        raise ValueError("translate_non_en needs translator= (the M2M100 model) and "
                         "tokenizer_for= (m2m100_dir, lang -> its tokenizer): the port "
                         "loads no transformers model itself")
    os.makedirs(output_dir, exist_ok=True)
    model = whisperx.load_model("large-v2", device="cpu")
    writer = whisperx.utils.get_writer("json", output_dir)
    done = []
    for lang, paths in audio_paths_by_lang.items():
        tokenizer = tokenizer_for(m2m100_dir, lang)
        try:
            model_a, metadata = whisperx.load_align_model(language_code=lang,
                                                          device="cpu")
        except Exception:
            model_a = None  # fall back to whisper's own translate task
        for path in remaining_after_drop_list(paths, output_dir):
            audio = whisperx.load_audio(path)
            if model_a is not None:
                native = model.transcribe(audio, batch_size=batch_size,
                                          language=lang)
                native = whisperx.align(native["segments"], model_a, metadata,
                                        audio, "cpu",
                                        return_char_alignments=False)
                texts = [s["text"] for s in native["segments"]]
                translated = batch_translate(translator, tokenizer, texts)
                for seg, en in zip(native["segments"], translated):
                    seg["text_en"] = en
                writer(native, path, {"highlight_words": False,
                                      "max_line_count": None,
                                      "max_line_width": None})
            else:
                result = model.transcribe(audio, batch_size=batch_size,
                                          language=lang, task="translate")
                writer(result, path, {"highlight_words": False,
                                      "max_line_count": None,
                                      "max_line_width": None})
            done.append(path)
    return done
