"""Runtime device / precision policy of the port.

Counterpart of ``multigridmc_tpu/utils/runtime.py``.  The JAX package selects
platform and precision through environment variables; here they are plain
arguments: every constructor and entry point takes ``device=`` and ``dtype=``.

* **Device.**  The default is ``cuda``.  With the default and no GPU present
  :func:`resolve_device` raises - nothing moves to the CPU silently.  Tests ask
  for ``device="cpu"`` explicitly.
* **Dtype.**  float32 is the production dtype; float64 on the CPU is the parity
  surface against the JAX package.
* **Matmul precision.**  TF32 is off and float32 matmul precision is
  "highest".  This is a correctness matter: the JAX package forces
  ``Precision.HIGHEST`` on every low-rank and intergrid contraction because
  reduced-precision passes destabilised the Woodbury-corrected Gibbs iteration
  (near-exact measurements make ``x - B_bar B^T x`` almost a projection).  TF32
  keeps about three decimal digits and is the GPU counterpart of that hazard.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

DEFAULT_DEVICE = "cuda"
DEFAULT_DTYPE = torch.float32


def configure_runtime() -> None:
    """Set and state the precision policy (idempotent; called on import of the
    modules that contract with ``torch.matmul``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the default
    (``cuda``).  Raises when a CUDA device is asked for and none is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "multigridmc_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' explicitly to run on the CPU")
    return dev


def resolve_dtype(dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """``dtype`` or the default float32."""
    return DEFAULT_DTYPE if dtype is None else dtype


def make_generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """A seeded :class:`torch.Generator` on ``device`` (counterpart of
    ``sampling_key``)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


configure_runtime()
