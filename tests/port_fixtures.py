"""Shared fixtures of the PyTorch port's tests: a tiny JAX TANWithText, its
weights moved into the port through ``state_dict_from_jax``, and synthetic
HTM-Align corpora made from a numpy seed so both packages see the same data.
"""

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
