"""milnce_roofline_pct.train: the MIL-NCE kernels' bound (forward 2·S·R·K·C, each gradient 4·S·R·K·C operations, or their bytes) over the device time of the kernels named milnce_* in the traced slice."""


def read(run):
    return run.roofline_pct("milnce", ("milnce_",))
