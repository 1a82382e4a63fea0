"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch
from torch._subclasses.fake_tensor import FakeTensor

DeviceLike = Union[str, torch.device, None]


def is_fake(t) -> bool:
    """A dry-run's stand-in (``FakeTensor``): shapes without data.  Code
    that reads a tensor's values on the host takes a static form for it
    (``launch/dryrun.py``); a real tensor never does."""
    return isinstance(t, FakeTensor)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  A CUDA device without CUDA raises: the
    port never carries on silently on the CPU.  On a CUDA device, TF32 is
    switched off for matmuls and cuDNN, so float32 products keep float32
    precision (the numerics contract compares fp32 against fp32); and
    cuBLAS may not reduce a bf16 product's partial sums in bf16 (split-K),
    so a bf16 matmul sums in fp32 and rounds once, as XLA's does."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) "
                "to run the port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
