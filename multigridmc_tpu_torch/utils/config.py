"""Configuration system: a libconfig-subset parser plus typed parameter groups.

Counterpart of ``multigridmc_tpu/utils/config.py`` (numpy only; the port keeps
its own copy).  The drivers read libconfig files that reference a second
measurements file; this module parses that file syntax (groups ``{...}``,
``key = value;``, lists ``[...]``, ``//``/``#`` comments), so the configuration
files of the JAX package's drivers work unchanged, and maps them onto
dataclasses, one per parameter group.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np


# --------------------------------------------------------------------- parser
_TOKEN_RE = re.compile(
    r"""
    (?P<comment>//[^\n]*|\#[^\n]*|/\*.*?\*/)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<float>[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?(?=[\s;,\]\}])?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_-]*)
  | (?P<punct>[={};,\[\]\(\)])
  | (?P<ws>\s+)
    """,
    re.VERBOSE | re.DOTALL,
)


def _tokenize(text: str) -> List[str]:
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ValueError(f"config parse error at: {text[pos:pos + 40]!r}")
        pos = m.end()
        if m.lastgroup in ("comment", "ws"):
            continue
        tokens.append(m.group())
    return tokens


def _parse_value(tokens: List[str], i: int):
    t = tokens[i]
    if t == "{":
        group: Dict[str, Any] = {}
        i += 1
        while tokens[i] != "}":
            name = tokens[i]
            assert tokens[i + 1] == "=", f"expected '=' after {name}"
            value, i = _parse_value(tokens, i + 2)
            group[name] = value
            if tokens[i] == ";":
                i += 1
        return group, i + 1
    if t in ("[", "("):
        return _parse_list(tokens, i)
    if t.startswith('"'):
        return t[1:-1], i + 1
    if t in ("true", "True", "TRUE"):
        return True, i + 1
    if t in ("false", "False", "FALSE"):
        return False, i + 1
    try:
        if re.fullmatch(r"[-+]?\d+", t):
            return int(t), i + 1
        return float(t), i + 1
    except ValueError:
        return t, i + 1


def _parse_list(tokens: List[str], i: int):
    close = "]" if tokens[i] == "[" else ")"
    values = []
    i += 1
    while tokens[i] != close:
        v, i = _parse_value(tokens, i)
        values.append(v)
        if i < len(tokens) and tokens[i] == ",":
            i += 1
    return values, i + 1


def parse_config(text: str) -> Dict[str, Any]:
    """Parse libconfig-subset text into nested dicts/lists."""
    tokens = _tokenize(text)
    result: Dict[str, Any] = {}
    i = 0
    while i < len(tokens):
        name = tokens[i]
        assert tokens[i + 1] == "=", f"expected '=' after {name!r}"
        i += 2
        if tokens[i] in ("[", "("):
            value, i = _parse_list(tokens, i)
        else:
            value, i = _parse_value(tokens, i)
        result[name] = value
        if i < len(tokens) and tokens[i] == ";":
            i += 1
    return result


def read_config(path) -> Dict[str, Any]:
    return parse_config(Path(path).read_text())


# ------------------------------------------------------------ parameter groups
@dataclasses.dataclass
class GeneralParameters:
    """The ``general`` block."""

    dim: int = 2
    do_cholesky: bool = False
    do_ssor: bool = False
    do_multigridmc: bool = True
    save_posterior_statistics: bool = False
    measure_convergence: bool = False
    operator: str = "posterior"  # "prior" or "posterior"
    # float32 zero-mean protocol: "auto" enables it whenever the run is
    # float32 (the default on a GPU), "on"/"off" force it.  Avoids the
    # O(cond(Q)*eps32) mean bias of direct-rhs float32 sampling while keeping
    # the reference semantics in float64 runs untouched.
    mean_shift: str = "auto"


@dataclasses.dataclass
class LatticeParameters:
    nx: int = 32
    ny: int = 32
    nz: int = 32


@dataclasses.dataclass
class CholeskyParameters:
    factorisation: str = "sparse"  # "sparse" or "dense"


@dataclasses.dataclass
class SmootherParameters:
    nsmooth: int = 1
    omega: float = 1.0


@dataclasses.dataclass
class IterativeSolverParamGroup:
    rtol: float = 1e-12
    atol: float = 1e-15
    maxiter: int = 100
    verbose: int = 0


@dataclasses.dataclass
class MultigridParameters:
    """The ``multigrid`` block.  Two extension keys beyond the reference's:

    * ``sweep_schedule`` - ``"fixed"`` (reference parity, default) or
      ``"alternating"``: odd steps swap the pre/post sweep directions.
    * ``distill_precision`` - precision tier of the distilled coarse-subtree
      matmuls (``"highest"``, ``"high"``, ``"default"`` or unset).

    Both are parsed and reach the MGMC sampler, which runs every value.
    """

    smoother: str = "SOR"
    coarse_solver: str = "Cholesky"
    npresmooth: int = 1
    npostsmooth: int = 1
    ncoarsesmooth: int = 1
    omega: float = 1.0
    nlevel: int = 4
    cycle: int = 1
    coarse_scaling: float = 1.0
    verbose: int = 0
    sweep_schedule: str = "fixed"
    distill_precision: Optional[str] = None


@dataclasses.dataclass
class SamplingParameters:
    nsamples: int = 10000
    nwarmup: int = 1000
    nstepsconvergence: int = 16
    nsamplesconvergence: int = 1000


@dataclasses.dataclass
class PriorParameters:
    pdemodel: str = "shiftedlaplace_fd"
    correlationlengthmodel: str = "constant"


@dataclasses.dataclass
class ConstantCorrelationLengthModelParameters:
    Lambda: float = 0.2


@dataclasses.dataclass
class PeriodicCorrelationLengthModelParameters:
    Lambda_min: float = 0.2
    Lambda_max: float = 0.4


def _fill(cls, block: Dict[str, Any], section: str = "", **extra):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(block) - fields)
    if unknown:
        # a typo'd key must not silently become a default
        import sys

        print(
            f"WARNING: unknown key(s) in config block '{section or cls.__name__}' "
            f"ignored: {', '.join(unknown)}",
            file=sys.stderr,
        )
    kwargs = {k: v for k, v in block.items() if k in fields}
    kwargs.update(extra)
    return cls(**kwargs)


@dataclasses.dataclass
class Config:
    """All parameter groups of a driver run."""

    general: GeneralParameters
    lattice: LatticeParameters
    cholesky: CholeskyParameters
    smoother: SmootherParameters
    iterative_solver: IterativeSolverParamGroup
    multigrid: MultigridParameters
    sampling: SamplingParameters
    prior: PriorParameters
    constant_correlationlength: ConstantCorrelationLengthModelParameters
    periodic_correlationlength: PeriodicCorrelationLengthModelParameters
    measurements: "MeasurementConfig"


@dataclasses.dataclass
class MeasurementConfig:
    """The ``measurements`` block + the referenced second config file."""

    radius: float = 0.0
    sample_location: Optional[np.ndarray] = None
    variance_scaling: float = 1.0
    measure_global: bool = False
    mean_global: float = 1.0
    variance_global: float = 0.01
    filename: str = ""
    # from the measurement file:
    dim: int = 2
    n: int = 0
    measurement_locations: Optional[np.ndarray] = None
    mean: Optional[np.ndarray] = None
    variance: Optional[np.ndarray] = None


def load_config(path) -> Config:
    """Load a full driver configuration from a libconfig file (and its
    referenced measurements file)."""
    path = Path(path)
    raw = read_config(path)

    sampling_raw = raw.get("sampling", {})
    ts = sampling_raw.get("timeseries", {})
    conv = sampling_raw.get("convergence", {})
    sampling = SamplingParameters(
        nsamples=ts.get("nsamples", 10000),
        nwarmup=ts.get("nwarmup", 1000),
        nstepsconvergence=conv.get("nsteps", 16),
        nsamplesconvergence=conv.get("nsamples", 1000),
    )

    known_sections = {
        "general", "lattice", "cholesky", "smoother", "iterative_solver",
        "multigrid", "sampling", "prior", "constantcorrelationlengthmodel",
        "periodiccorrelationlengthmodel", "measurements",
    }
    unknown_sections = sorted(set(raw) - known_sections)
    if unknown_sections:
        import sys

        print(
            f"WARNING: unknown config section(s) ignored: {', '.join(unknown_sections)}",
            file=sys.stderr,
        )

    meas_raw = dict(raw.get("measurements", {}))
    meas = _fill(MeasurementConfig, meas_raw, "measurements")
    if meas.sample_location is not None:
        meas.sample_location = np.asarray(meas_raw["sample_location"], dtype=np.float64)
    if meas.filename:
        mfile = Path(meas.filename)
        if not mfile.is_absolute():
            mfile = path.parent / mfile
        if mfile.exists():
            mraw = read_config(mfile)
            meas.dim = int(mraw.get("dim", meas.dim))
            meas.n = int(mraw.get("n", 0))
            locs = np.asarray(mraw.get("measurement_locations", []), dtype=np.float64)
            meas.measurement_locations = locs.reshape(meas.n, meas.dim)
            meas.mean = np.asarray(mraw.get("mean", []), dtype=np.float64)
            meas.variance = np.asarray(mraw.get("variance", []), dtype=np.float64)

    return Config(
        general=_fill(GeneralParameters, raw.get("general", {}), "general"),
        lattice=_fill(LatticeParameters, raw.get("lattice", {}), "lattice"),
        cholesky=_fill(CholeskyParameters, raw.get("cholesky", {}), "cholesky"),
        smoother=_fill(SmootherParameters, raw.get("smoother", {}), "smoother"),
        iterative_solver=_fill(
            IterativeSolverParamGroup, raw.get("iterative_solver", {}), "iterative_solver"
        ),
        multigrid=_fill(MultigridParameters, raw.get("multigrid", {}), "multigrid"),
        sampling=sampling,
        prior=_fill(PriorParameters, raw.get("prior", {}), "prior"),
        constant_correlationlength=_fill(
            ConstantCorrelationLengthModelParameters,
            raw.get("constantcorrelationlengthmodel", {}),
            "constantcorrelationlengthmodel",
        ),
        periodic_correlationlength=_fill(
            PeriodicCorrelationLengthModelParameters,
            raw.get("periodiccorrelationlengthmodel", {}),
            "periodiccorrelationlengthmodel",
        ),
        measurements=meas,
    )


def echo_config(config: Config, file=None) -> None:
    """Print the fully parsed configuration: every effective value is shown,
    so defaulted/typo'd settings are visible."""
    import sys

    file = file or sys.stdout
    for group_field in dataclasses.fields(config):
        group = getattr(config, group_field.name)
        print(f"{group_field.name}:", file=file)
        for f in dataclasses.fields(group):
            v = getattr(group, f.name)
            if isinstance(v, np.ndarray):
                v = np.array2string(np.asarray(v).reshape(-1)[:8], precision=6) + (
                    " ..." if v.size > 8 else ""
                )
            print(f"    {f.name} = {v}", file=file)
