"""Subprocess entry of the port's kill-during-save test
(tests/test_torch_resume.py): runs the port's train CLI with its checkpoint
writes instrumented at the runtime save of step $TAN_KILL_AT_STEP, landing
where $TAN_KILL_LANDING says, then writes $TAN_KILL_MARKER and parks until
the parent's SIGKILL:

- ``mid_write``: the temporary file holds the first half of the checkpoint's
  bytes and was never renamed;
- ``before_rotation``: the new file is in place, the older runtime file not
  yet deleted.
"""

import os
import sys
import time

import torch

from temporalalignnet_torch.checkpoint import io

torch.set_num_threads(2)  # as the test process, so the runs are bit-equal

_MARKER = os.environ["TAN_KILL_MARKER"]
_KILL_AT = int(os.environ["TAN_KILL_AT_STEP"])
_LANDING = os.environ["TAN_KILL_LANDING"]
_real_save = io.Checkpointer.save_runtime


def _park():
    with open(_MARKER, "w") as f:
        f.write(_LANDING)
    time.sleep(300)


def _instrumented_save(self, state, step):
    if step != _KILL_AT:
        return _real_save(self, state, step)
    if _LANDING == "mid_write":
        tmp = os.path.join(self.runtime_dir, f"step_{step:09d}.pth.tar.tmp{os.getpid()}")
        torch.save(state, tmp)
        with open(tmp, "r+b") as f:
            f.truncate(os.path.getsize(tmp) // 2)
        _park()
    real_remove = io.os.remove

    def remove(path):
        _park()
        real_remove(path)

    io.os.remove = remove
    return _real_save(self, state, step)


io.Checkpointer.save_runtime = _instrumented_save

from temporalalignnet_torch.train.cli import main  # noqa: E402

if __name__ == "__main__":
    main(sys.argv[1:])
