"""The port's one device rule.

Every public function that takes ``device`` resolves it here: a named
device wins; with none, the device of the first tensor the function was
given; with no tensor either, the CUDA card.  Asking for CUDA where there
is none raises instead of falling back to the CPU, so a user on the card
never runs the plain versions on the host without a word (the kernel
wrappers route by the device of their inputs).
"""

from __future__ import annotations

import torch


def resolve(device=None, like=(), who="this call builds"):
    """The ``torch.device`` a call should build on: ``device`` if named,
    else that of the first tensor in ``like`` (other entries, such as None
    or ints, are passed over), else CUDA.  Raises ``RuntimeError`` where
    the answer is CUDA and ``torch.cuda.is_available()`` is False; ``who``
    begins the message."""
    if device is not None:
        dev = torch.device(device)
    else:
        dev = next((t.device for t in like if torch.is_tensor(t)), None) or torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} on CUDA unless given a device, but "
                           "torch.cuda.is_available() is False; pass device='cpu'")
    return dev
