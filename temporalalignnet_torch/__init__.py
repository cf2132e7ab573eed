"""temporalalignnet_torch — the PyTorch/CUDA port of temporalalignnet_tpu.

The JAX package beside it is the reference; each module here keeps the name of
its counterpart there.  It runs the zero-shot HTM-Align evaluation and the
Stage-1 training of a word2vec TAN:

- core/        Model, loss, data, train and eval configs and the precision
               policy (torch dtypes).
- ops/         Attention and the fused MIL-NCE: plain PyTorch references and
               the hand-written Hopper kernels (csrc/*.cu) with their autograd
               Functions, built by ops/_build.py.
- models/      TemporalAligner, TANWithText, the word2vec text tower, pos-enc.
- losses/      The Stage-1 loss (multi-layer MIL-NCE, threshold, BCE head).
- train/       AdamW with the reference's groups and schedule, the train step,
               the train CLI.
- checkpoint/  The JAX param tree and reference .pth.tar checkpoints -> the
               reference state_dict key space, and back to .pth.tar.
- data/        HowTo100M feature dataset and loader, HTM-Align dataset,
               padding helpers, synthetic batches and corpora (numpy).
- eval/        AlignmentEvaluator (overlap-seq and global), metrics, CLI.

Entry points run on ``cuda`` unless the caller asks for ``cpu``.  On a CPU
tensor every kernel wrapper takes its plain PyTorch version; on a CUDA tensor
it launches the kernel or raises.
"""

__version__ = "0.1.0"
