"""attn_roofline_pct.train: the attention kernels' bound (max(bytes / HBM rate, FLOPs / bf16 peak) per launch, from the cell's shapes) over the device time of the kernels named mha_fwd* and mha_bwd* in the traced slice."""


def read(run):
    return run.roofline_pct("attention", ("mha_fwd", "mha_bwd"))
