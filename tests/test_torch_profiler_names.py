"""How ``chip_smoke.py`` reads device times: a kernel is matched by its full
name in the profiler's demangled signature (never by a substring of another
kernel's name), and a device-bound launch's event and device times must agree.
Pure host code, checked here on the CPU with the signatures the card's profiler
printed."""

import pytest

import chip_smoke

SIGNATURES = {
    "passes_gibbs": "void passes_gibbs_kernel<0, false>(VisitParams, int const*, float*, "
                    "float const*, float*, float const*, float const*, float const*, "
                    "unsigned long long*)",
    "generic_gibbs": "void gibbs_sweep_kernel<false>(SweepParams, float*, float const*, float*, "
                     "float const*, float const*, float const*, unsigned long long*)",
    "split_sweep": "void cluster_sweep_kernel<false>(SweepParams, float*, float const*, "
                   "float const*, float const*, float const*)",
    "split_gibbs": "void cluster_sweep_kernel<true>(SweepParams, float*, float const*, "
                   "float const*, float const*, float const*)",
    "stream_descend": "void stream_visit_kernel<true, 5, true>(StreamParams, float*)",
    "phase_descend": "void descend_kernel<0, false>(VisitParams, PhaseTables, int4 const*)",
    "memcpy": "Memcpy DtoD (Device -> Device)",
    "smem_descend_5pt": "void smem_visit_kernel<5, true, false>(SmemVisitParams, int const*, "
                        "float*, float const*, float*, float*, float const*, float const*, "
                        "float const*, float const*, float const*, float const*, float const*, "
                        "float const*, float const*, float const*, float const*, "
                        "unsigned long long*)",
    "smem_ascend_25pt": "void smem_visit_kernel<25, false, false>(SmemVisitParams, int const*, "
                        "float*)",
    "phase_descend_ssor": "void descend_kernel<0, false, 2>(VisitParams, PhaseTables, "
                          "int4 const*)",
}


@pytest.mark.parametrize("key,kernel,match", [
    ("passes_gibbs", "passes_gibbs_kernel", True),
    ("passes_gibbs", "gibbs_kernel", False),
    ("generic_gibbs", "gibbs_sweep_kernel", True),
    ("passes_gibbs", "gibbs_sweep_kernel", False),
    ("split_sweep", "cluster_sweep_kernel<false", True),
    ("split_gibbs", "cluster_sweep_kernel<false", False),
    ("split_gibbs", "cluster_sweep_kernel<true>", True),
    ("stream_descend", "stream_visit_kernel<true", True),
    ("stream_descend", "stream_visit_kernel<false", False),
    ("stream_descend", "visit_kernel", False),
    ("phase_descend", "descend_kernel", True),
    ("phase_descend", "descend_kernel<0, false>", True),
    ("phase_descend", "descend_kernel<1", False),
    ("memcpy", "Memcpy DtoD", True),
    ("memcpy", "copy", False),
    # the 2d smem kernels by stencil size: the reach-1 5-point kernel is not the
    # reach-2 25-point one, nor a visit kernel of another route
    ("smem_descend_5pt", "smem_visit_kernel<5, true", True),
    ("smem_descend_5pt", "smem_visit_kernel<25, true", False),
    ("smem_descend_5pt", "smem_visit_kernel<5, false", False),
    ("smem_descend_5pt", "visit_kernel", False),
    ("smem_ascend_25pt", "smem_visit_kernel<25, false", True),
    ("smem_ascend_25pt", "smem_visit_kernel<5", False),
    ("phase_descend_ssor", "descend_kernel<0", True),
    ("phase_descend_ssor", "smem_visit_kernel<5, true", False),
])
def test_kernels_match_by_full_name(key, kernel, match):
    assert chip_smoke.names_kernel(SIGNATURES[key], kernel) is match


def test_profiler_kernel_name_splits_template_arguments():
    assert chip_smoke.profiler_kernel_name(SIGNATURES["stream_descend"]) == (
        "stream_visit_kernel", ("true", "5", "true"))
    assert chip_smoke.profiler_kernel_name("mgmc_subtree_kernel(SubtreeParams)") == (
        "mgmc_subtree_kernel", ())
    assert chip_smoke.profiler_kernel_name("void k<a<1, 2>, b>(int)") == ("k", ("a<1, 2>", "b"))


@pytest.mark.parametrize("ms,device_ms,host_ms,fails", [
    (0.871, 0.8659, 0.02, False),   # the 63^3 Gibbs sweep, re-measured
    (0.877, 0.414, 0.02, True),     # its old single-window reading
    (0.2153, 0.2059, 0.03, False),
    (0.11, 0.05, 0.02, True),       # device-bound, and half the events
    (0.0305, 0.0145, 0.03, False),  # one chain of 255^2 split: under 0.1 ms
    (0.1074, 0.0338, 0.1, False),   # one chain of 127^2 split: the host's launch rate
    (0.5, 0.7, 0.02, True),         # a device time above the events
])
def test_device_bound_launches_agree_with_their_events(ms, device_ms, host_ms, fails):
    if fails:
        with pytest.raises(AssertionError, match="device-bound"):
            chip_smoke.check_events_against_device("k", ms, device_ms, host_ms)
    else:
        assert chip_smoke.check_events_against_device("k", ms, device_ms, host_ms) == (
            ms / device_ms)
    with pytest.raises(AssertionError, match="no device time"):
        chip_smoke.check_events_against_device("k", ms, None, host_ms)
