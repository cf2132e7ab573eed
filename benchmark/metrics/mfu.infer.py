"""mfu.infer: % of the card's bf16 peak that the eval forward's model FLOPs make over the window (counted from the cell's shapes by benchmark/work.py)."""


def read(run):
    return run.mfu()
