"""PyTorch + CUDA port of the PIFS-Rec engine and DLRM serving path.

The JAX package ``repro`` is the reference this port is held against; this
package imports nothing of it and nothing of JAX.  Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU
(``device="cpu"``); without CUDA they raise instead of falling back.
"""
from repro_torch.device import resolve_device  # noqa: F401
