"""PyTorch and CUDA port of `tokenizers_tpu` for one NVIDIA H100.

A package of its own: it imports torch and numpy, and nothing of JAX or
of `tokenizers_tpu`.  Its entry points run on the card.  On a tensor on
the CPU each kernel runs its plain PyTorch version instead, which is how
the tests ask for it (`device="cpu"`); without a card and without that
request the entry points raise.  The kernels of `csrc/` are built with
`nvcc` at first use (`ops/kernel_build.py`).
"""

from __future__ import annotations

import torch


def pick_device(device=None) -> torch.device:
    """`device` if given, else the card; raises when there is no card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run the kernels' plain versions on the CPU"
        )
    return torch.device("cuda")


from .encoding import Encoding  # noqa: E402
from .tokenizer import Tokenizer  # noqa: E402

__all__ = ["Encoding", "Tokenizer", "pick_device"]
