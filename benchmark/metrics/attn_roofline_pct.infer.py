"""attn_roofline_pct.infer: the forward attention kernels' bound over the device time of the kernels named mha_fwd* in the traced slice."""


def read(run):
    return run.roofline_pct("attention", ("mha_fwd",))
