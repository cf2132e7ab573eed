"""The port's offline text pipeline against the JAX package's, on the CPU:
the caption filters, ``Sentencify`` with the JAX tests' ``FakePunctuator``,
``process_htm`` end to end (the files it writes), ``convert_captions``
(byte-equal, read by the port's ``JsonlCaptionStore``), the ASR stages with
a stand-in ``whisperx``, and ``HFPunctuator`` on a tiny random BERT token
classifier: the port's BERT (f32) against JAX's, which runs transformers'
model (installed here only, as the oracle).  Every input is made from a
numpy seed; outputs must be equal, logits within ``LOGIT_TOL``."""

import json
import os
import random
import sys
import types

import numpy as np
import pytest
import torch
from transformers import BertConfig as HFBertConfig
from transformers import BertForTokenClassification as HFTokenClassifier

from test_tools import FakePunctuator
from temporalalignnet_torch.tools import convert_captions, filters, process_htm, sentencify
from temporalalignnet_torch.tools import whisper_asr
from temporalalignnet_tpu.tools import convert_captions as jax_convert
from temporalalignnet_tpu.tools import filters as jax_filters
from temporalalignnet_tpu.tools import process_htm as jax_process_htm
from temporalalignnet_tpu.tools import sentencify as jax_sentencify
from temporalalignnet_tpu.tools import whisper_asr as jax_whisper_asr

torch.set_num_threads(2)

LOGIT_TOL = 2e-5  # the forward bar (tests/test_checkpoint.py::test_full_forward_parity)
# bert-base-uncased's layout: Sentencify writes [CLS] 101 and [SEP] 102 itself
SPECIALS = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
            + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
WORDS = ["now", "we", "cut", "the", "onion", "into", "small", "pieces", "then", "heat",
         "pan", "and", "fry", "it", "gently", "add", "salt", "oil", "stir", "until", "golden",
         "so", "you", "can", "see", "this", "is", "very", "good", "'", "s", "don", "t"]
PIECES = ["##ing", "##ed", "##s", "##ly"]  # "cutting" -> cut ##ting is [UNK]; "heated" splits
TINY_BERT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=128, max_position_embeddings=512, num_labels=15)


def _captions(rng, n, punctuated=False, min_words=3, max_words=9):
    """n captions of words drawn from WORDS (with a few out-of-vocabulary and
    wordpiece words), 1 s each with glitches and overlaps."""
    extra = ["cooking", "heated", "mixed", "zzyzx", "it's", "don't"]
    caps, starts, ends, t = [], [], [], 0.0
    for i in range(n):
        k = rng.randint(min_words, max_words + 1)
        words = [str(w) for w in rng.choice(WORDS[:-4] + extra, k)]
        if punctuated:
            words[-1] += "." if rng.rand() < 0.6 else ","
        caps.append(" ".join(words))
        dur = 0.1 if rng.rand() < 0.05 else 0.5 + rng.rand() * 2.0
        starts.append(round(t, 3))
        ends.append(round(t + dur, 3))
        t += dur - (0.3 if rng.rand() < 0.2 else -1.5 * (rng.rand() < 0.1))
    return caps, starts, ends


# ------------------------------------------------------------------ filters


MERGE_CASES = {
    "glitch_and_music": (["[MUSIC]", "hello there", "glitch", "  "], [0.0, 1.0, 5.0, 7.0],
                         [0.5, 4.0, 5.1, 9.0]),
    "rolling_two_line": (["hello world\nhow are you", "how are you\ntoday my friends"],
                         [0.0, 2.0], [2.0, 4.0]),
    "startswith_dedup": (["so we", "so we take the", "so we take the onion", "and cut"],
                         [0.0, 1.0, 2.0, 3.0], [1.0, 2.0, 3.0, 4.0]),
    "overlap_average": (["first caption", "second caption"], [0.0, 1.0], [2.0, 3.0]),
}


@pytest.mark.parametrize("case", list(MERGE_CASES) + ["seed0", "seed1", "seed2"])
def test_merge_linebreaks_equals_jax(case):
    if case in MERGE_CASES:
        args = MERGE_CASES[case]
    else:
        rng = np.random.RandomState(int(case[-1]))
        caps, starts, ends = _captions(rng, 40)
        # rolling two-line captions and startswith growth, as YouTube writes them
        for i in range(0, 30, 7):
            caps[i] = caps[i] + "\n" + caps[i + 1].split(" ")[0]
            caps[i + 1] = caps[i + 1].split(" ")[0] + "\n" + caps[i + 1]
            caps[i + 3] = caps[i + 2] + " " + caps[i + 3]
        caps[5] = "[Music]"
        args = (caps, starts, ends)
    assert filters.merge_linebreaks(*args) == jax_filters.merge_linebreaks(*args)


@pytest.mark.parametrize("seed", range(3))
def test_length_and_language_filters_equal_jax(seed):
    """The stopword fallback (no langdetect on either machine) and the same
    draws from a seeded ``random.Random``."""
    rng = np.random.RandomState(seed)
    spanish = "ahora vamos a cortar la cebolla en trozos pequenos si".split()
    for n in (5, 11, 30):
        caps = _captions(rng, n)[0]
        mixed = [" ".join(rng.choice(spanish, 6)) if rng.rand() < 0.5 else c for c in caps]
        for c in (caps, mixed, ["one two"] * n):
            assert filters.filter_length(c) == jax_filters.filter_length(c)
            assert (filters.filter_language(c, random.Random(seed))
                    == jax_filters.filter_language(c, random.Random(seed)))
    assert not filters._HAVE_LANGDETECT and not jax_filters._HAVE_LANGDETECT


# --------------------------------------------------------------- sentencify


class WordPieces(FakePunctuator):
    """tests/test_tools.py's wordpiece punctuator: 'cutting' -> cut ##ting."""

    def tokenize(self, text):
        out = []
        for w in text.split():
            out += ["cut", "##ting"] if w == "cutting" else [w]
        return out


SENTENCIFY_CASES = {
    "full_stops": (FakePunctuator, {}, ["we cut the onion then heat the pan", "and fry gently"],
                   [0.0, 8.0], [8.0, 12.0]),
    "silence_gap": (FakePunctuator, dict(stop_after=()), ["hello there friends", "welcome back"],
                    [0.0, 10.0], [3.0, 12.0]),
    "hysteresis": (FakePunctuator, dict(stop_after=("w5", "w25"), label=4),
                   [" ".join(f"w{i}" for i in range(30))], [0.0], [30.0]),
    "already_punctuated": (FakePunctuator, {}, ["First sentence. And then",
                                                "a second one. Third starts"],
                           [0.0, 4.0], [4.0, 8.0]),
    "wordpiece": (WordPieces, dict(stop_after=("cut",)), ["we are cutting onions now"],
                  [0.0], [5.0]),
}


@pytest.mark.parametrize("case", list(SENTENCIFY_CASES) + ["long_stream", "punctuated_stream"])
def test_sentencify_equals_jax(case):
    """The JAX tests' cases and two long seeded caption streams (several
    256-token chunks; the already-punctuated path)."""
    if case in SENTENCIFY_CASES:
        cls, kw, *args = SENTENCIFY_CASES[case]
    else:
        cls, kw = FakePunctuator, dict(stop_after=("onion", "pan", "salt", "golden"))
        args = list(_captions(np.random.RandomState(7), 120,
                              punctuated=case == "punctuated_stream"))
    ours = sentencify.Sentencify(cls(**kw)).punctuate_and_cut(*args)
    theirs = jax_sentencify.Sentencify(cls(**kw)).punctuate_and_cut(*args)
    assert ours == theirs
    assert sentencify.LABEL_LIST == jax_sentencify.LABEL_LIST
    assert sentencify.Sentencify.punctuate is sentencify.Sentencify.punctuate_and_cut


# ------------------------------------------------------- the BERT punctuator


def _write_punct_dir(path, fmt="safetensors", seed=0):
    """A tiny random BertForTokenClassification in HF's directory layout
    (config.json with 15 labels, vocab.txt, the weights), its classifier
    scaled so that the 15 labels' logits spread."""
    torch.manual_seed(seed)
    model = HFTokenClassifier(HFBertConfig(vocab_size=len(SPECIALS + WORDS + PIECES),
                                           **TINY_BERT)).eval()
    with torch.no_grad():
        model.classifier.weight.mul_(40.0)
    model.save_pretrained(str(path), safe_serialization=fmt == "safetensors")
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("".join(t + "\n" for t in SPECIALS + WORDS + PIECES))
    return str(path)


@pytest.fixture(scope="module")
def punct_dir(tmp_path_factory):
    return _write_punct_dir(tmp_path_factory.mktemp("punct"))


def _chunk_inputs(seed, n_tokens, chunk=256):
    """``Sentencify._predict_labels``' [chunks, <= chunk + 2] ids and mask."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(len(SPECIALS), len(SPECIALS + WORDS + PIECES), n_tokens)
    rows = [[101] + c.tolist() + [102] for c in np.array_split(ids, n_tokens // chunk + 1)]
    out = np.zeros((len(rows), max(map(len, rows))), np.int64)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out, (out != 0).astype(np.int64)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_punctuator_logits_equal_transformers(tmp_path, fmt):
    """The port's token classifier (no transformers) against JAX's
    HFPunctuator on one directory: the tokens, the ids and, per element,
    the logits of padded multi-chunk inputs (<= LOGIT_TOL)."""
    path = _write_punct_dir(tmp_path / fmt, fmt)
    ours = sentencify.HFPunctuator(path, device="cpu")
    theirs = jax_sentencify.HFPunctuator(path)
    text = "now we re-heat the pan, it's golden!  and don't stir zzyzx cooking heated"
    assert ours.tokenize(text) == theirs.tokenize(text)
    toks = ours.tokenize(text)
    assert ours.convert_tokens_to_ids(toks) == theirs.convert_tokens_to_ids(toks)
    for seed, n in ((0, 700), (1, 40)):
        ids, mask = _chunk_inputs(seed, n)
        a, b = ours.predict(ids, mask), theirs.predict(ids, mask)
        assert a.shape == b.shape == ids.shape + (15,) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)
    assert set(ours._model.state_dict()) == set(HFTokenClassifier(
        HFBertConfig(vocab_size=len(SPECIALS + WORDS + PIECES), **TINY_BERT)).state_dict())


def test_punctuator_sentences_equal_jax(punct_dir):
    """Sentencify over the two punctuators: the same sentences and times,
    and the model's labels vary (the comparison is not of one label)."""
    ours = sentencify.Sentencify(sentencify.HFPunctuator(punct_dir, device="cpu"))
    theirs = jax_sentencify.Sentencify(jax_sentencify.HFPunctuator(punct_dir))
    for seed in range(3):
        args = _captions(np.random.RandomState(10 + seed), 90)
        out = ours.punctuate_and_cut(*args)
        assert out == theirs.punctuate_and_cut(*args)
        assert 2 < len(out[0]) < sum(len(c.split()) for c in args[0])


def test_punctuator_refuses_cuda_without_a_card_and_a_dir_without_weights(tmp_path, punct_dir):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sentencify.HFPunctuator(punct_dir)  # the default device is the card
    os.makedirs(tmp_path / "empty")
    for name in ("config.json", "vocab.txt"):
        with open(os.path.join(punct_dir, name)) as f, open(tmp_path / "empty" / name, "w") as g:
            g.write(f.read())
    with pytest.raises(ValueError, match="no model.safetensors"):
        sentencify.HFPunctuator(str(tmp_path / "empty"), device="cpu")


# ---------------------------------------------------------------- pipeline


def _raw_corpus(path, punctuated, videos=6, seed=3):
    rng = np.random.RandomState(seed)
    raw = {}
    for i in range(videos):
        caps, starts, ends = _captions(rng, 25 + 5 * i, punctuated=punctuated)
        # English for any sample of five: the filter's draws differ with the
        # pool's scheduling (in both packages), its verdict must not
        caps = ["so we are going to " + c for c in caps]
        raw[f"vid{i:02d}"] = {"text": caps, "start": starts, "end": ends}
    raw["short"] = {"text": ["hi"], "start": [0.0], "end": [1.0]}
    raw["spanish"] = {"text": ["ahora vamos a cortar la cebolla en trozos pequenos"] * 12,
                      "start": list(range(12)), "end": list(range(1, 13))}
    with open(path, "w") as f:
        json.dump(raw, f)
    return str(path)


def _outputs(paths):
    out = {}
    for p in paths:
        with open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    return out


@pytest.mark.parametrize("punct", ["model", "skip_path"])
def test_process_htm_writes_the_jax_files(tmp_path, punct_dir, punct):
    """``main`` of both packages on one raw corpus: the same chunk files,
    byte for byte, through the port's BERT punctuator on the CPU
    (``--device cpu``) or, without ``--punct_model_dir``, the skip path."""
    raw = _raw_corpus(tmp_path / "raw.json", punctuated=punct == "skip_path")
    flags = ["--num_chunks", "3", "--jobs", "2"]
    if punct == "model":
        flags += ["--punct_model_dir", punct_dir]
    random.seed(0)
    ours = process_htm.main(["--raw_caption", raw, "--out_dir", str(tmp_path / "ours"), *flags]
                            + (["--device", "cpu"] if punct == "model" else []))
    random.seed(0)
    theirs = jax_process_htm.main(["--raw_caption", raw, "--out_dir", str(tmp_path / "jax"),
                                   *flags])
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    assert _outputs(ours) == _outputs(theirs)
    kept = {}
    for p in ours:
        with open(p) as f:
            kept.update(json.load(f))
    assert len(kept) == 6 and "short" not in kept and "spanish" not in kept


def test_sentencify_chunks_prefetched_equals_serial_and_jax(tmp_path):
    raw = _raw_corpus(tmp_path / "raw.json", punctuated=False, videos=5)
    filtered = process_htm.filter_chunks(process_htm.split_chunks(raw, str(tmp_path), 3), 2)
    punct = dict(stop_after=("onion", "pan", "salt"))
    piped = _outputs(process_htm.sentencify_chunks(
        filtered, sentencify.Sentencify(FakePunctuator(**punct)), prefetch=2))
    serial = _outputs([process_htm.sentencify_chunk(
        f, sentencify.Sentencify(FakePunctuator(**punct))) for f in filtered])
    jax_out = _outputs(jax_process_htm.sentencify_chunks(
        filtered, jax_sentencify.Sentencify(FakePunctuator(**punct)), prefetch=2))
    assert piped == serial == jax_out


def test_skip_path_refuses_unpunctuated_captions(tmp_path):
    raw = _raw_corpus(tmp_path / "raw.json", punctuated=False, videos=2)
    with pytest.raises(RuntimeError, match="--punct_model_dir required"):
        process_htm.main(["--raw_caption", raw, "--out_dir", str(tmp_path / "o"),
                          "--num_chunks", "1", "--jobs", "1"])


def test_convert_captions_byte_equal_and_read_by_the_port(tmp_path):
    from temporalalignnet_torch.data.htm import JsonlCaptionStore

    rng = np.random.RandomState(5)
    src = {f"v{i}": dict(zip(("text", "start", "end"), _captions(rng, 4 + i)))
           for i in range(30)}
    src["csv_vid"] = "/data/captions/csv_vid.csv"  # the htm-fe layout
    src["ünï"] = {"text": ["café crème ✓"], "start": [0.0], "end": [1.5]}
    path = tmp_path / "caps.json"
    path.write_text(json.dumps(src, ensure_ascii=False, indent=1), encoding="utf-8")
    n = convert_captions.convert(str(path), str(tmp_path / "ours.jsonl"))
    assert n == jax_convert.convert(str(path), str(tmp_path / "jax.jsonl")) == len(src)
    assert (tmp_path / "ours.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    convert_captions.main([str(path)])  # the default output name
    assert (tmp_path / "caps.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    store = JsonlCaptionStore(str(tmp_path / "ours.jsonl"))
    for vid in ("v0", "v29", "ünï"):
        assert store[vid] == src[vid]


# --------------------------------------------------------------------- ASR


class _Writer:
    def __init__(self, out_dir):
        self.out_dir = out_dir

    def __call__(self, result, path, options):
        name = os.path.basename(path).split(".")[0] + ".json"
        with open(os.path.join(self.out_dir, name), "w") as f:
            json.dump({"result": result, "options": options}, f, sort_keys=True)


class _Model:
    def __init__(self):
        self.model = types.SimpleNamespace(
            encode=lambda mel: mel.sum(),
            model=types.SimpleNamespace(detect_language=lambda enc: [[("<|de|>", 0.75)]]))

    def transcribe(self, audio, batch_size, language, task="transcribe"):
        n = int(audio.sum()) % 3 + 1
        return {"segments": [{"text": f"{language} {task} {i}", "start": float(i),
                              "end": float(i + 1)} for i in range(n)]}


def _fake_whisperx():
    """A stand-in ``whisperx`` (neither machine has it): audio is the file's
    bytes, alignment adds word stamps, the writer writes the JSON it got."""
    wx = types.ModuleType("whisperx")
    wx.load_model = lambda name, device: _Model()
    wx.load_audio = lambda path: np.frombuffer(open(path, "rb").read(), np.uint8).astype(
        np.float32)
    wx.audio = types.SimpleNamespace(log_mel_spectrogram=lambda a: a[:80])

    def load_align_model(language_code, device):
        if language_code == "xx":
            raise ValueError("no align model")
        return f"align-{language_code}", {"language": language_code}

    wx.load_align_model = load_align_model
    wx.align = lambda segs, model_a, meta, audio, device, return_char_alignments: {
        "segments": [dict(s, words=[s["start"]], aligned=model_a) for s in segs]}
    wx.utils = types.SimpleNamespace(get_writer=lambda fmt, out_dir: _Writer(out_dir))
    return wx


class _Translator:
    def generate(self, input_ids, forced_bos_token_id):
        return [[forced_bos_token_id] + list(r) for r in input_ids]


class _Tokenizer:
    def __init__(self, lang):
        self.lang = lang

    def __call__(self, batch, return_tensors, padding):
        return {"input_ids": [[len(s), len(batch)] for s in batch]}

    def get_lang_id(self, lang):
        return 7 if lang == "en" else 9

    def batch_decode(self, tokens, skip_special_tokens):
        return [f"en({self.lang}):{t}" for t in tokens]


def test_whisper_logic_equals_jax(tmp_path):
    for n, bs in ((0, 4), (10, 4), (3, 4), (17, 5)):
        sents = [f"s{i}" for i in range(n)]
        assert (whisper_asr.chunk_for_translation(sents, bs)
                == jax_whisper_asr.chunk_for_translation(sents, bs))
    (tmp_path / "a.json").write_text("{}")
    todo = ["/x/a.wav", "/x/b.wav", "/y/a.mp3", "/y/c.tar.wav"]
    assert (whisper_asr.remaining_after_drop_list(todo, str(tmp_path))
            == jax_whisper_asr.remaining_after_drop_list(todo, str(tmp_path)) == todo[1::2])
    with pytest.raises(ImportError, match="whisperx is required"):
        whisper_asr._require_whisperx()
    tr, tok = _Translator(), _Tokenizer("de")
    assert (whisper_asr.batch_translate(tr, tok, [f"t{i}" for i in range(9)], 4)
            == jax_whisper_asr.batch_translate(tr, tok, [f"t{i}" for i in range(9)], 4))


def test_whisper_stages_equal_jax_with_a_stand_in_whisperx(tmp_path, monkeypatch):
    """The three stages of both packages on one stand-in backend: the csv and
    the per-audio JSON files, byte-equal; a resumed stage skips what exists."""
    monkeypatch.setitem(sys.modules, "whisperx", _fake_whisperx())
    audio = []
    for i in range(5):
        p = tmp_path / "audio" / f"clip{i}.wav"
        p.parent.mkdir(exist_ok=True)
        p.write_bytes(bytes(range(i, 60 + 7 * i)))
        audio.append(str(p))
    outs = {}
    for name, mod in (("ours", whisper_asr), ("jax", jax_whisper_asr)):
        root = tmp_path / name
        csv_path = mod.detect_languages(audio, str(root / "lang.csv"))
        assert mod.detect_languages(audio, csv_path) == csv_path  # exists: skipped
        done_en = mod.transcribe_en(audio[:3], str(root / "en"))
        assert mod.transcribe_en(audio[:3], str(root / "en")) == []  # resumed: nothing left
        by_lang = {"de": audio[3:], "xx": audio[:1]}
        if mod is jax_whisper_asr:  # its M2M100 classes from a stand-in transformers
            hf = types.ModuleType("transformers")
            hf.M2M100ForConditionalGeneration = types.SimpleNamespace(
                from_pretrained=lambda d: _Translator())
            hf.M2M100Tokenizer = types.SimpleNamespace(
                from_pretrained=lambda d, src_lang: _Tokenizer(src_lang))
            with monkeypatch.context() as m:
                m.setitem(sys.modules, "transformers", hf)
                done_x = mod.translate_non_en(by_lang, str(root / "x"), "m2m100")
        else:
            with pytest.raises(ValueError, match="translator="):
                mod.translate_non_en(by_lang, str(root / "x"), "m2m100")
            done_x = mod.translate_non_en(by_lang, str(root / "x"), "m2m100",
                                          translator=_Translator(),
                                          tokenizer_for=lambda d, lang: _Tokenizer(lang))
        files = sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
        outs[name] = (done_en, done_x, {f: (root / f).read_bytes() for f in files})
    assert outs["ours"] == outs["jax"]
    assert len(outs["ours"][2]) == 1 + 3 + 3
