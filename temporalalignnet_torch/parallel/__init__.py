"""Data and tensor parallelism over ``torch.distributed``: one process per
card, NCCL on the card and gloo on the CPU (counterpart of
temporalalignnet_tpu/parallel/).

- ``distributed``: the process group from the launcher's flags or
  environment, the master gate, and the collectives as autograd Functions;
- ``mesh``: the (dp, tp) mesh (its size checked against the world, its
  subgroups), each rank's batch rows, and the eval helpers that split a
  host array over the ranks and gather the pieces back;
- ``tensor``: the encoder blocks' column- and row-parallel layers, the
  shard and gather of a state_dict.
"""
