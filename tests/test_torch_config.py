"""The port's configuration module against the JAX package's: the same
libconfig text parses to the same nested values, and ``load_config`` gives the
same ``Config`` field for field (arrays compared exactly; both are numpy-only
code on the same text).  The configurations are written by the tests; nothing
is read from outside the temporary directory.
"""

import dataclasses
import io

import numpy as np
import pytest

from multigridmc_tpu.utils import config as jconfig

from multigridmc_tpu_torch.convert import config_from_dict
from multigridmc_tpu_torch.utils import config as pconfig

from test_drivers import CONFIG, MEASUREMENTS

CONFIG_3D = CONFIG.replace("dim = 2;", "dim = 3;").replace(
    "nx = 8; ny = 8; nz = 8;", "nx = 8; ny = 12; nz = 16;").replace(
    "sample_location = [0.5, 0.5];", "sample_location = [0.5, 0.25, 0.75];")
MEASUREMENTS_3D = """
dim = 3;
n = 2;
measurement_locations = [0.25, 0.25, 0.5, 0.75, 0.3, 0.1];
mean = [1.0, -2.0];
variance = [1.0e-6, 2.5e-3];
"""
CONFIG_PERIODIC = CONFIG.replace('correlationlengthmodel = "constant";',
                                 'correlationlengthmodel = "periodic";').replace(
    "Lambda_min = 0.2; Lambda_max = 0.4;", "Lambda_min = 0.15; Lambda_max = 0.35;").replace(
    'smoother = "SOR"; coarse_solver = "Cholesky";',
    'smoother = "SSOR"; coarse_solver = "SSOR"; sweep_schedule = "alternating";\n'
    '    distill_precision = "highest";')
CONFIG_GLOBAL = CONFIG.replace("measure_global = false;", "measure_global = true;").replace(
    "radius = 0.0;", "radius = 0.1;  // averaged over a disc\n    # a second comment style").replace(
    "do_cholesky = true;", "do_cholesky = FALSE;").replace(
    'operator = "posterior";', 'operator = "posterior";\n    mean_shift = "off";')

CASES = {
    "drivers_test": (CONFIG, MEASUREMENTS),
    "3d": (CONFIG_3D, MEASUREMENTS_3D),
    "periodic_ssor": (CONFIG_PERIODIC, MEASUREMENTS),
    "global_measurement": (CONFIG_GLOBAL, MEASUREMENTS),
}


def _assert_same(a, b, path="config"):
    """Field-for-field equality of two dataclass trees (of different classes)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        names = [f.name for f in dataclasses.fields(a)]
        assert names == [f.name for f in dataclasses.fields(b)], path
        for name in names:
            _assert_same(getattr(a, name), getattr(b, name), f"{path}.{name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, f"{path}: {a!r} != {b!r}"


@pytest.mark.parametrize("case", list(CASES))
def test_parse_config_matches_jax(case):
    for text in CASES[case]:
        assert pconfig.parse_config(text) == jconfig.parse_config(text)


@pytest.mark.parametrize("case", list(CASES))
def test_load_config_matches_jax(case, tmp_path):
    text, measurements = CASES[case]
    (tmp_path / "params.cfg").write_text(text)
    (tmp_path / "measurements.cfg").write_text(measurements)
    want = jconfig.load_config(tmp_path / "params.cfg")
    got = pconfig.load_config(tmp_path / "params.cfg")
    _assert_same(got, want)
    assert got.measurements.n == (2 if case == "3d" else 3)
    assert got.measurements.measurement_locations.shape == (got.measurements.n,
                                                           got.general.dim)
    # the echo prints the same lines
    out_p, out_j = io.StringIO(), io.StringIO()
    pconfig.echo_config(got, file=out_p)
    jconfig.echo_config(want, file=out_j)
    assert out_p.getvalue() == out_j.getvalue() and "measurements:" in out_p.getvalue()
    # a parsed Config of the JAX package carried across as plain dictionaries
    carried = config_from_dict(dataclasses.asdict(want))
    assert isinstance(carried, pconfig.Config)
    _assert_same(carried, want)


def test_defaults_and_variants(tmp_path, capsys):
    (tmp_path / "empty.cfg").write_text("general = { dim = 2; }\n")
    got = pconfig.load_config(tmp_path / "empty.cfg")
    _assert_same(got, jconfig.load_config(tmp_path / "empty.cfg"))
    assert got.cholesky.factorisation == "sparse" and got.general.mean_shift == "auto"
    assert got.multigrid.sweep_schedule == "fixed" and got.multigrid.distill_precision is None
    assert got.measurements.measurement_locations is None
    periodic = pconfig.parse_config(CONFIG_PERIODIC)
    assert periodic["multigrid"]["sweep_schedule"] == "alternating"
    assert periodic["periodiccorrelationlengthmodel"] == {"Lambda_min": 0.15, "Lambda_max": 0.35}
    glob = pconfig.parse_config(CONFIG_GLOBAL)
    assert glob["measurements"]["measure_global"] is True and glob["general"]["do_cholesky"] is False
    assert glob["measurements"]["radius"] == 0.1
    # a typo'd key or section is reported, not silently defaulted
    (tmp_path / "typo.cfg").write_text("general = { dmi = 3; }\nlatice = { nx = 4; }\n")
    capsys.readouterr()
    pconfig.load_config(tmp_path / "typo.cfg")
    err = capsys.readouterr().err
    assert "dmi" in err and "latice" in err
    with pytest.raises(ValueError, match="parse error"):
        pconfig.parse_config("general = { dim = 2; } @")
