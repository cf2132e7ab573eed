"""The port's eval CLI (python -m temporalalignnet_torch.eval --device cpu)
against the JAX package's eval CLI on the same .pth.tar, features and vocab."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_fixtures import TINY, VOCAB, jax_model
from temporalalignnet_tpu.checkpoint import save_reference_checkpoint
from temporalalignnet_tpu.eval.cli import main as jax_eval_main

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    # the CLI builds 1024 pos-enc slots, the reference's (no flag sets it)
    _, params = jax_model(use_alignability_head=True, num_pos_embeds=1024)
    ckpt = str(root / "tan.pth.tar")
    save_reference_checkpoint(ckpt, params)
    words = np.array([f"w{i}" for i in range(VOCAB)])
    np.save(root / "vocab.npy", words)
    feat = root / "features"
    feat.mkdir()
    anno = {}
    for v in range(3):
        vlen = int(rng.randint(70, 140))
        np.save(feat / f"vid{v}.npy", rng.randn(vlen, TINY["video_embed_dim"]).astype(np.float32))
        sents, t = [], 2.0
        while t < vlen - 8 and len(sents) < 9:
            text = " ".join(rng.choice(words, size=rng.randint(2, 6)))
            sents.append([int(rng.rand() < 0.6), t, t + 6.0, text])
            t += float(rng.randint(7, 14))
        anno[f"vid{v}"] = sents
    (root / "htm_align.json").write_text(json.dumps(anno))
    return ["--task", "align", "--ckpt", ckpt, "--features", str(feat),
            "--anno", str(root / "htm_align.json"), "--vocab", str(root / "vocab.npy"),
            "--seq_len", "32", "--max_words", "8",
            "--video_embed_dim", str(TINY["video_embed_dim"]),
            "--num_encoder_layers", str(TINY["num_encoder_layers"]),
            "--num_joint_layers", str(TINY["num_joint_layers"]),
            "--width", str(TINY["width"]), "--heads", str(TINY["heads"])]


@pytest.mark.parametrize("method", ["overlap-seq", "global"])
def test_cli_metrics_equal_jax_cli(files, method, capsys):
    args = files + ["--method", method]
    out = subprocess.run(
        [sys.executable, "-m", "temporalalignnet_torch.eval", *args, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"},
    )
    assert out.returncode == 0, out.stderr
    ours = json.loads(out.stdout.strip().splitlines()[-1])
    ref = jax_eval_main(args + ["--f32"])
    assert ours["Recall"] == ref["Recall"]
    assert ours["AUC"] == pytest.approx(ref["AUC"], abs=1e-12)


def test_cli_refuses_cuda_without_a_card(files):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from temporalalignnet_torch.eval.cli import main

    with pytest.raises(SystemExit, match="no CUDA device"):
        main(files)


@pytest.mark.parametrize("flag", [["--shard_eval"], ["--multihost"]])
def test_eval_cli_refuses_flags_of_later_slices(files, flag):
    """The JAX eval CLI's multi-GPU flags: ``--shard_eval`` without a process
    group and ``--multihost --shard_eval`` in a world of one give the
    metrics of the plain run, and the CLI leaves no process group behind."""
    import socket

    from temporalalignnet_torch.eval.cli import main

    plain = main(files + ["--device", "cpu"])
    if flag == ["--multihost"]:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        flag = flag + ["--coordinator", f"127.0.0.1:{port}", "--num_processes", "1",
                       "--process_id", "0", "--shard_eval"]
    assert main(files + flag + ["--device", "cpu"]) == plain
    assert not torch.distributed.is_initialized()
