"""The cap-1024 cases of tests/test_torch_binned_slots.py (the binned soft
tier's static tile slots, on the CPU with one torch thread): the same tests,
from a file of their own so that `--dist loadfile` runs them beside the
cap-512 ones rather than after them."""
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import test_torch_binned_slots as base  # noqa: E402
from test_torch_binned_slots import no_host_reads  # noqa: E402,F401 (fixture)
from test_torch_hpr_binned import one_torch_thread, view9  # noqa: E402,F401 (module fixtures)

CASES = [(1024, strat) for strat in (True, False)]


@pytest.mark.parametrize("scene", sorted(base.SCENES))
@pytest.mark.parametrize("cap,strat", CASES)
def test_slot_count_equals_the_twin(scene, cap, strat, view9, monkeypatch):
    base.test_slot_count_equals_the_twin(scene, cap, strat, view9, monkeypatch)


@pytest.mark.parametrize("scene", sorted(base.SCENES))
@pytest.mark.parametrize("cap,strat", CASES)
def test_static_slots_match_jax(scene, cap, strat, view9):
    base.test_static_slots_match_jax(scene, cap, strat, view9)


@pytest.mark.parametrize("cap,strat", CASES)
def test_binned_mask_reads_nothing_on_the_host(cap, strat, view9, no_host_reads):
    base.test_binned_mask_reads_nothing_on_the_host(cap, strat, view9, no_host_reads)


@pytest.mark.parametrize("cap,strat", CASES)
def test_soft_steps_read_nothing_on_the_host(cap, strat, monkeypatch, no_host_reads):
    base.test_soft_steps_read_nothing_on_the_host(cap, strat, monkeypatch, no_host_reads)
