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


def write_feature_dir(root, videos=7):
    """``videos`` videos of S3D-like features with sentencified captions, as
    .json and .jsonl, a vocab, and a holdout list naming vid5 (``root`` a
    Path)."""
    rng = np.random.RandomState(0)
    words = [f"w{i}" for i in range(VOCAB)]
    np.save(root / "vocab.npy", np.array(words))
    (root / "features").mkdir()
    caps = {}
    for v in range(videos):
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


def write_milnce_checkpoint(path, vocab_rows, video_dim, seed=0, drop=()):
    """An s3d_howto100m.pth-format file of random tensors from ``seed``: the
    word2vec text tower (vocab_rows x 300 table, fc1 300 -> 2048, fc2 2048 ->
    512), the 1024 -> 512 ``fc`` (here video_dim -> 512), a few S3D conv and
    BN keys, and keys the converter does not recognise, under ``module.``
    and ``"state_dict"`` as a DataParallel save holds them; the text keys in
    ``drop`` are left out.  Returns the text tower's tensors under the port's
    Word2VecEncoder keys."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=g) * 0.05
    text = {"word_embd.weight": rand(vocab_rows, 300), "fc1.weight": rand(2048, 300),
            "fc1.bias": rand(2048), "fc2.weight": rand(512, 2048), "fc2.bias": rand(512)}
    text = {k: v for k, v in text.items() if k not in drop}
    sd = {f"module.text_module.{k}": v for k, v in text.items()}
    sd.update({"module.fc.weight": rand(512, video_dim), "module.fc.bias": rand(512),
               "module.conv1.conv1.weight": rand(64, 3, 3, 7, 7),
               "module.conv1.bn1.weight": rand(64), "module.conv1.bn1.bias": rand(64),
               "module.conv1.bn1.running_mean": rand(64),
               "module.conv1.bn1.running_var": rand(64).abs(),
               "module.conv1.bn1.num_batches_tracked": torch.tensor(7),
               "module.conv1.bn1.momentum_extra": rand(64),
               "module.mixed_3b.gating.scale": rand(8),
               "module.text_module.word_embd_extra.weight": rand(4)})
    torch.save({"state_dict": sd}, path)
    return text


def jax_s3d_variables(model, *inputs, seed=0):
    """Variables of a JAX S3D or S3DWithText, made from a numpy seed in the
    shapes of its init (``jax.eval_shape``: no init compile): convs He
    normal, Dense LeCun normal, biases small, BN scale near 1 and its running
    statistics randomised, so a swapped stat or transpose shows.  An
    S3DWithText's come as {'params': {'video', 'text'}, 'batch_stats'}."""
    rng = np.random.RandomState(seed)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(model.init, key, *inputs)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name == "embedding":
            return rng.randn(*shape).astype(np.float32) * 0.3
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name == "mean":
            return rng.uniform(-0.2, 0.2, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.randn(*shape) * 0.02).astype(np.float32)  # biases

    return jax.tree_util.tree_map_with_path(fill, shapes)


# ----------------------------------------------------- 2-process gloo runs


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """The jobs of ``tests/torch_mp_worker.py`` running on ``world`` CPU
    processes joined by gloo, started at once; ``result(name)`` waits for
    the processes (once) and returns each rank's result of a job."""

    def __init__(self, job_dir, jobs, world=2, timeout=300):
        import os
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for job in jobs:
            if job["kind"] == "cli":
                job["port"] = free_port()
        self.job_dir, self.timeout = job_dir, timeout
        torch.save(jobs, os.path.join(job_dir, "jobs.pt"))
        port = free_port()
        env = {**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "1"}
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(repo, "tests", "torch_mp_worker.py"), str(r),
             str(world), str(port), str(job_dir)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        self.outputs = None

    def wait(self):
        if self.outputs is None:
            self.outputs = [p.communicate(timeout=self.timeout)[0] for p in self.procs]
            for p, out in zip(self.procs, self.outputs):
                assert p.returncode == 0, out[-6000:]
        return self.outputs

    def result(self, name):
        import os

        self.wait()
        return [torch.load(os.path.join(self.job_dir, f"{name}.{r}.pt"), weights_only=False)
                for r in range(len(self.procs))]

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
