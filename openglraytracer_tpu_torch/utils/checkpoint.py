"""Checkpoints of the inverse-rendering fit: its parameters, the optimizer's
state and the step.

Port of ``openglraytracer_tpu/utils/checkpoint.py`` on ``torch.save`` and
``torch.load``, with the reference's contract: steps are numbered, at most
``MAX_TO_KEEP`` checkpoints are kept (the oldest go first), and
``restore_latest`` returns None when the directory does not exist or holds
no checkpoint. A checkpoint is written to a temporary name and renamed into
place, so a run killed while saving leaves no torn checkpoint behind.
"""

from __future__ import annotations

import logging
import os
import re

import torch

log = logging.getLogger(__name__)

MAX_TO_KEEP = 3
_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _steps(directory: str) -> list[int]:
    """The numbered steps saved in directory, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := _NAME.match(f)))


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:09d}.pt")


def save(directory: str, state, step: int) -> None:
    """Save state (any structure of tensors, dicts, lists and numbers, such
    as {params, optimizer.state_dict(), step}) as checkpoint step, then
    delete all but the newest MAX_TO_KEEP. Waits for the device: the
    tensors are copied to the host."""
    os.makedirs(directory, exist_ok=True)
    final = _path(directory, step)
    tmp = final + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, final)
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        os.remove(_path(directory, old))


def restore_latest(directory: str, like=None):
    """The newest checkpoint of directory, or None when there is none.
    like: a tensor (or None) whose device the tensors are loaded onto, the
    run's device; None keeps the devices they were saved from."""
    steps = _steps(directory)
    if not steps:
        return None
    device = like.device if isinstance(like, torch.Tensor) else like
    state = torch.load(_path(directory, steps[-1]), map_location=device,
                       weights_only=True)
    log.info("restored checkpoint step %d from %s", steps[-1], directory)
    return state
