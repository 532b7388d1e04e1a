"""Chain checkpoint and resume.

Counterpart of ``multigridmc_tpu/utils/checkpoint.py``.  The reference has no
checkpointing (its chains are regenerated from fixed seeds); for long sampling
runs this keeps the state of the chains durable.  A step of the port's samplers
is a function of the chain state ``x`` and of the noise source alone, so the
state is ``x``, the noise state and the step count (plus any accumulated
statistics).  The noise state takes the place of the JAX key: a
:class:`~multigridmc_tpu_torch.samplers.base.GeneratorNoise`'s seed, the state
of its ``torch.Generator`` (which feeds the tensor draws) and its Philox launch
counter (which feeds the kernels' in-kernel draws).  Restored, the same steps
follow: ``k`` steps, a save and a load, then ``k`` more give what ``2 k``
uninterrupted steps give, bit for bit.

A multi-device run keeps one file per rank: the rank's block of ``x`` and the
noise source every rank shares, with the rank's own streams that its sampler
derived and keeps on that source (``GeneratorNoise.streams``: the chains
path's ``"rank"``, the lattice cycle's ``"lattice"`` and ``"chains"``), each
saved as the source is.  Loaded, the source carries them again, and the
sampler draws on from them.  A source without streams (one card) is saved as
before.

The file is a compressed ``.npz`` with its metadata as JSON, written to a
temporary name and renamed into place.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..samplers.base import GeneratorNoise
from .runtime import DeviceLike, resolve_device

VERSION = 1


def _noise_arrays(noise: GeneratorNoise, prefix: str = "") -> Dict[str, np.ndarray]:
    """A noise source's seed, generator state and Philox launches."""
    return {f"{prefix}seed": np.asarray(noise.seed, dtype=np.uint64),
            f"{prefix}generator_state": noise.generator.get_state().cpu().numpy(),
            f"{prefix}philox_launches": np.asarray(noise.launches, dtype=np.int64)}


def _noise_from(data, device: torch.device, prefix: str = "") -> GeneratorNoise:
    """The noise source :func:`_noise_arrays` saved under ``prefix``."""
    noise = GeneratorNoise(int(data[f"{prefix}seed"]), device)
    noise.generator.set_state(torch.from_numpy(data[f"{prefix}generator_state"].copy()))
    noise.launches = int(data[f"{prefix}philox_launches"])
    return noise


@dataclasses.dataclass
class ChainState:
    """Complete MCMC chain state: ``x`` (a tensor ``(*, *vshape)``), the
    production noise source (with the streams derived from it), the step count
    and optional statistics (name -> array)."""

    x: torch.Tensor
    noise: GeneratorNoise
    step: int
    stats: Optional[Dict[str, Any]] = None

    def save(self, path) -> None:
        path = Path(path)
        payload = {"x": self.x.detach().cpu().numpy(), "step": np.asarray(self.step),
                   **_noise_arrays(self.noise)}
        meta = {"version": VERSION, "stats_keys": [], "x_dtype": str(self.x.dtype),
                "generator_device": self.noise.device.type}
        if self.noise.streams:
            meta["streams"] = sorted(self.noise.streams)
            for name in meta["streams"]:
                payload.update(_noise_arrays(self.noise.streams[name], f"stream/{name}/"))
        for k, v in (self.stats or {}).items():
            payload[f"stat_{k}"] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                                    else np.asarray(v))
            meta["stats_keys"].append(k)
        payload["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, **payload)
        tmp.replace(path)  # atomic on POSIX

    @classmethod
    def load(cls, path, device: DeviceLike = None) -> "ChainState":
        """The state saved at ``path``, ``x`` and the noise source on
        ``device`` (default: the card).  The generator's state is that of a
        generator on a device of the saved type: a state saved on the card
        resumes on a card, one saved on the CPU on the CPU.  The source
        carries the streams saved with it."""
        device = resolve_device(device)
        with np.load(Path(path)) as data:
            meta = json.loads(bytes(data["meta"]).decode())
            if meta["generator_device"] != device.type:
                raise ValueError(f"the checkpoint's generator ran on {meta['generator_device']}, "
                                 f"not on {device.type}: its state does not transfer")
            noise = _noise_from(data, device)
            noise.streams = {name: _noise_from(data, device, f"stream/{name}/")
                             for name in meta.get("streams", ())}
            x = torch.from_numpy(data["x"].copy()).to(device)
            stats = {k: data[f"stat_{k}"] for k in meta["stats_keys"]} or None
            return cls(x=x, noise=noise, step=int(data["step"]), stats=stats)
