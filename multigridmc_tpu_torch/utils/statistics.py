"""Online vector-valued chain statistics.

Counterpart of ``multigridmc_tpu/utils/statistics.py``: running mean and second
moment (Welford-style incremental updates), covariance estimator, windowed
autocovariance C(k) over the last k_max samples, and the integrated
autocorrelation time tau_int in a direction v.

Two implementations:

* :class:`Statistics` - host-side incremental recorder with the reference's
  exact update formulas, for drivers and diagnostics;
* :func:`chain_statistics_scan` - a loop over a step function and a noise
  source that accumulates the moments of whole batched chains on the device.
"""

from __future__ import annotations

from collections import deque
from typing import List

import numpy as np
import torch


class Statistics:
    """Incremental recorder of vector-valued samples."""

    def __init__(self, label: str, autocorr_window: int):
        self.label = label
        self.k_max = int(autocorr_window)
        self.reset()

    def reset(self) -> None:
        self.n_samples = 0
        self.avg = None
        self.avg2 = None
        self.Q_k: deque = deque()
        self.S_k: List[np.ndarray] = []

    def record_sample(self, Q) -> None:
        """Incremental update."""
        Q = np.atleast_1d(np.asarray(Q, dtype=np.float64))
        self.n_samples += 1
        if self.n_samples == 1:
            self.avg = Q.copy()
            self.avg2 = np.outer(Q, Q)
        else:
            self.avg += (Q - self.avg) / self.n_samples
            self.avg2 += (np.outer(Q, Q) - self.avg2) / self.n_samples
        self.Q_k.appendleft(Q)
        if len(self.Q_k) > self.k_max:
            self.Q_k.pop()
        for k in range(len(self.Q_k)):
            N_k = self.n_samples - k
            S = np.outer(self.Q_k[0], self.Q_k[k])
            if N_k == 1:
                self.S_k.append(S)
            else:
                self.S_k[k] += (S - self.S_k[k]) / N_k

    def average(self) -> np.ndarray:
        return self.avg

    def covariance(self) -> np.ndarray:
        """Unbiased estimator."""
        n = self.n_samples
        return n / (n - 1.0) * (self.avg2 - np.outer(self.avg, self.avg))

    def auto_covariance(self) -> List[np.ndarray]:
        """C(k) = S_k - avg avg^T."""
        return [S - np.outer(self.avg, self.avg) for S in self.S_k]

    def tau_int(self, v) -> float:
        """Integrated autocorrelation time in direction v."""
        v = np.atleast_1d(np.asarray(v, dtype=np.float64))
        C_k = self.auto_covariance()
        variance = v @ C_k[0] @ v
        tau = 1.0
        kmax = len(C_k)
        for k in range(1, kmax):
            cov = v @ C_k[k] @ v
            tau += 2.0 * (1.0 - k / kmax) * cov / variance
        return tau

    def samples(self) -> int:
        return self.n_samples

    def autocorr_window(self) -> int:
        return self.k_max

    def __str__(self) -> str:
        lines = [
            f" {self.label}: Avg = {self.average()}",
            f" {self.label}: Var = {self.covariance()}",
        ]
        dim = len(self.avg)
        for j in range(dim):
            v = np.zeros(dim)
            v[j] = 1.0
            lines.append(f" {self.label}: tau_int,{j} = {self.tau_int(v):.3f}")
        lines.append(f" {self.label}: window      = {self.autocorr_window()}")
        lines.append(f" {self.label}: # samples   = {self.samples()}")
        return "\n".join(lines)


def chain_statistics_scan(step_fn, x0, noise, nsteps, observe_fn=None):
    """Run a chain for ``nsteps`` steps, accumulating first and second moments
    on the device.

    ``step_fn(noise, x) -> x`` advances the chain with the noise source
    ``noise``; ``observe_fn(x) -> z`` maps the state to the observed vector
    (identity-flatten by default).  Returns ``(x_final, mean, second_moment)``
    averaged over steps (and any leading batch dimensions of the observation).
    """
    if observe_fn is None:
        observe_fn = lambda x: x.reshape(-1)  # noqa: E731

    z0 = observe_fn(x0)
    nobs = z0.shape[-1]
    nbatch = int(np.prod(z0.shape[:-1])) if z0.ndim > 1 else 1
    sx = torch.zeros((nobs,), dtype=x0.dtype, device=x0.device)
    sxx = torch.zeros((nobs, nobs), dtype=x0.dtype, device=x0.device)
    x = x0
    for _ in range(nsteps):
        x = step_fn(noise, x)
        z2 = observe_fn(x).reshape(-1, nobs)
        sx = sx + z2.sum(dim=0)
        sxx = sxx + z2.T @ z2
    total = nsteps * nbatch
    return x, sx / total, sxx / total
