"""Where the port's entry points run.

Every entry point (`Groth16Prover`, `NTTPlan`, `MxuNTTPlan`,
`groth16_setup`, the `testgen` generators) runs on the card unless its
caller asks for the CPU with ``device="cpu"``. Asking for the card where
there is none is an error: no entry point falls back to the CPU.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    """The torch device for `device`; raises if it is a CUDA device and
    no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' to run on the CPU")
    return dev
