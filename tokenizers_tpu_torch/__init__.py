"""PyTorch and CUDA port of `tokenizers_tpu` for one NVIDIA H100.

A package of its own: it imports torch and numpy, and nothing of JAX or
of `tokenizers_tpu`.  It offers the JAX package's public API, name for
name: a JAX user switches by changing the import.  Its entry points run
on the card.  On a tensor on the CPU each kernel runs its plain PyTorch
version instead, which is how the tests ask for it (`device="cpu"`, or
`set_default_device("cpu")` for every entry point given no device);
without a card and without that request the entry points raise.  The
kernels of `csrc/` are built with `nvcc` at first use
(`ops/kernel_build.py`).
"""

from __future__ import annotations

import torch


_default_device = None  # what pick_device(None) gives; None is the card


def set_default_device(device) -> "torch.device | None":
    """Make `device` what `pick_device(None)` returns, and return the
    previous setting, so that a caller can put it back.

    This is the port's counterpart of the JAX package's
    `JAX_PLATFORMS=cpu`: `set_default_device("cpu")` sends every entry
    point of this process that is given no device (tokenizers, trainers,
    the process groups of `parallel.runtime`) to the CPU, where each
    kernel runs its plain version.  `set_default_device(None)` gives the
    card back.  It is a call, never an environment variable, and there is
    no fallback: with no setting and no card `pick_device(None)` raises.
    """
    global _default_device
    previous = _default_device
    _default_device = None if device is None else torch.device(device)
    return previous


def pick_device(device=None) -> torch.device:
    """`device` if given, else the device set by `set_default_device`,
    else the card; raises when it comes to the card and there is none."""
    if device is not None:
        return torch.device(device)
    if _default_device is not None:
        return _default_device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu', "
            "or call set_default_device('cpu'), to run the kernels' plain "
            "versions on the CPU"
        )
    return torch.device("cuda")


from .added_vocabulary import AddedToken  # noqa: E402
from .encoding import Encoding  # noqa: E402
from .errors import (  # noqa: E402
    InputError,
    ModelError,
    SerdeError,
    TokenizersError,
    TrainingError,
    TruncationError,
)
from .normalized import NormalizedString  # noqa: E402
from .pretokenized import PreTokenizedString, Token  # noqa: E402
from .tokenizer import DecodeStream, Tokenizer  # noqa: E402

from . import decoders  # noqa: E402
from . import models  # noqa: E402
from . import normalizers  # noqa: E402
from . import pre_tokenizers  # noqa: E402
from . import processors  # noqa: E402
from . import trainers  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "AddedToken",
    "Encoding",
    "TokenizersError",
    "TruncationError",
    "SerdeError",
    "ModelError",
    "TrainingError",
    "InputError",
    "NormalizedString",
    "PreTokenizedString",
    "Token",
    "Tokenizer",
    "DecodeStream",
    "decoders",
    "models",
    "normalizers",
    "pre_tokenizers",
    "processors",
    "trainers",
    "pick_device",
    "set_default_device",
]
