"""temporalalignnet_torch — the PyTorch/CUDA port of temporalalignnet_tpu.

The JAX package beside it is the reference; each module here keeps the name of
its counterpart there.  This slice runs the zero-shot HTM-Align evaluation of a
word2vec TAN:

- core/        ModelConfig, EvalConfig and the precision policy (torch dtypes).
- ops/         Attention: the plain PyTorch reference and the hand-written
               Hopper kernel (csrc/mha_fwd.cu), built by ops/_build.py.
- models/      TemporalAligner, TANWithText, the word2vec text tower, pos-enc.
- checkpoint/  The JAX param tree and reference .pth.tar checkpoints -> the
               reference state_dict key space.
- data/        HTM-Align dataset, padding helpers, synthetic corpora (numpy).
- eval/        AlignmentEvaluator (overlap-seq and global), metrics, CLI.

Entry points run on ``cuda`` unless the caller asks for ``cpu``.  On a CPU
tensor every kernel wrapper takes its plain PyTorch version; on a CUDA tensor
it launches the kernel or raises.
"""

__version__ = "0.1.0"
