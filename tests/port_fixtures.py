"""Shared fixtures of the PyTorch port's tests: a tiny JAX TANWithText, its
weights moved into the port through ``state_dict_from_jax``, synthetic
HTM-Align corpora made from a numpy seed so both packages see the same data,
and a tiny HowTo100M-format training directory.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from temporalalignnet_torch.checkpoint import state_dict_from_jax
from temporalalignnet_torch.core.config import ModelConfig
from temporalalignnet_torch.data.synthetic import synthetic_video_corpus
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_tpu.core.config import ModelConfig as JaxModelConfig
from temporalalignnet_tpu.models.net import TANWithText as JaxTANWithText

TINY = dict(width=64, heads=4, num_encoder_layers=2, num_joint_layers=2,
            video_embed_dim=32, num_pos_embeds=256)
VOCAB = 50  # words; token ids 1..50, 0 = pad
WORDS = 8


def jax_model(use_pallas=False, **kw):
    cfg = JaxModelConfig(**{**TINY, **kw})
    model = JaxTANWithText(cfg, vocab_size=VOCAB + 1, use_pallas=use_pallas)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "pos": key}, jnp.zeros((1, 16, cfg.video_embed_dim)),
                        jnp.zeros((1, 2, WORDS), jnp.int32), deterministic=True)["params"]
    return model, jax.device_get(params)


def port_model(params, **kw):
    """The port's TANWithText with the JAX weights, loaded strict, f32 on the CPU."""
    model = TANWithText(ModelConfig(**{**TINY, **kw}), vocab_size=VOCAB + 1)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


def model_pair(**kw):
    jm, params = jax_model(**kw)
    return jm, params, port_model(params, **kw)


def make_corpus(rng, **kw):
    corpus = synthetic_video_corpus(rng, feature_dim=TINY["video_embed_dim"],
                                    vocab_size=VOCAB, **kw)
    for item in corpus:
        for s in item["sentences"]:
            ids = np.zeros(WORDS, np.int32)
            tok = s.pop("tokens")[:WORDS]
            ids[: len(tok)] = tok
            s["input_ids"] = ids
    return corpus


def to_torch(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def write_feature_dir(root):
    """Seven videos of S3D-like features with sentencified captions, as .json
    and .jsonl, a vocab, and a holdout list naming vid5 (``root`` a Path)."""
    rng = np.random.RandomState(0)
    words = [f"w{i}" for i in range(VOCAB)]
    np.save(root / "vocab.npy", np.array(words))
    (root / "features").mkdir()
    caps = {}
    for v in range(7):
        vlen = int(rng.randint(70, 160))
        suffix = ".mp4.npy" if v % 2 else ".webm.npy"
        np.save(root / "features" / f"vid{v}{suffix}",
                rng.randn(vlen, TINY["video_embed_dim"]).astype(np.float32))
        t, text, start, end = 0.0, [], [], []
        while t < vlen + 5:  # some captions run past the video's end
            d = float(rng.randint(2, 9)) + rng.rand()
            text.append(" ".join(rng.choice(words, size=rng.randint(1, 6))))
            start.append(t)
            end.append(t + d)
            t += d + rng.rand() * 2
        caps[f"vid{v}"] = {"text": text, "start": start, "end": end}
    (root / "captions.json").write_text(json.dumps(caps))
    with open(root / "captions.jsonl", "w") as f:
        for vid, rec in caps.items():
            f.write(json.dumps({"vid": vid, **rec}) + "\n")
    (root / "holdout.txt").write_text("vid5\n")
    return root


# the tiny model's shape flags of the train and eval CLIs
CLI_SHAPE = ["--video_embed_dim", str(TINY["video_embed_dim"]), "--width", str(TINY["width"]),
             "--heads", str(TINY["heads"]),
             "--num_encoder_layers", str(TINY["num_encoder_layers"]),
             "--num_joint_layers", str(TINY["num_joint_layers"]), "--max_words", str(WORDS)]
