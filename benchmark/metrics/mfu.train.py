"""mfu.train: % of the card's bf16 peak that the TAN train step's model FLOPs make over the window (forward, backward and the MIL-NCE logits, counted from the cell's shapes by benchmark/work.py, attention at valid keys, nothing recomputed)."""


def read(run):
    return run.mfu()
