"""chip_smoke.py at tiny sizes: every phase's control flow and reference
check on the CPU (the distributed phases on the virtual 8-device mesh),
and its refusal to report a result without a GPU."""
import jax
import pytest

import chip_smoke

#: each single-card phase with sizes small enough for the CPU
SMALL_SINGLE = [
    (chip_smoke.phase_precision, dict(n_direct=8, n_mixed=256, batch=16,
                                      reps=1)),
    (chip_smoke.phase_headline, dict(n=64, batch=32, sample=8, reps=1)),
    (chip_smoke.phase_f64, dict(n=64, batch=16, sample=8, reps=1)),
    (chip_smoke.phase_primes, dict(sizes=(17, 38), batch=8, reps=1)),
    (chip_smoke.phase_r2c2d, dict(batch=2, n=32, reps=1)),
    (chip_smoke.phase_dct2, dict(n=32, batch=16, reps=1)),
    (chip_smoke.phase_c2c3d, dict(n=16, reps=1)),
    (chip_smoke.phase_gradient, dict(n=32, batch=8, reps=1)),
    (chip_smoke.phase_model, dict(n=32, steps=5)),
]

SMALL_MULTI = [
    (chip_smoke.phase_slab3d, dict(n=8, reps=1)),
    (chip_smoke.phase_r2c_dist, dict(n=16, batch=2, reps=1)),
    (chip_smoke.phase_pencil, dict(n=8, reps=1)),
    (chip_smoke.phase_six_step, dict(n=256, reps=1)),
    (chip_smoke.phase_filter_step, dict(batch=2, n=8, reps=1)),
]


def _id(case):
    return case[0].__name__


def test_every_phase_has_a_small_case():
    assert [p for p, _ in SMALL_SINGLE] == chip_smoke.SINGLE_PHASES
    assert [p for p, _ in SMALL_MULTI] == chip_smoke.MULTI_PHASES


@pytest.mark.parametrize("case", SMALL_SINGLE, ids=_id)
def test_single_phase_small(case, capsys):
    phase, sizes = case
    phase(**sizes)
    out = capsys.readouterr().out
    assert "relerr=" in out and "time=" in out


@pytest.mark.parametrize("case", SMALL_MULTI, ids=_id)
def test_multi_phase_small(case, capsys):
    phase, sizes = case
    phase(jax.devices()[:4], **sizes)
    assert "time=" in capsys.readouterr().out


def test_run_phases_reports_failures(capsys):
    def phase_ok():
        pass

    def phase_bad():
        raise AssertionError("rel err 1 >= 0.001")

    assert chip_smoke.run_phases([phase_ok, phase_bad]) == ["phase_bad"]
    assert "phase_bad: FAILED" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_refuses_cpu(argv, capsys):
    """No GPU: exit status 2 and no result line on standard output."""
    assert chip_smoke.main(argv) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "needs an NVIDIA GPU" in captured.err


def test_check_raises_past_tolerance():
    assert chip_smoke._check("x", 1e-4, 1e-3) == 1e-4
    with pytest.raises(AssertionError):
        chip_smoke._check("x", 2e-3, 1e-3)
    with pytest.raises(AssertionError):
        chip_smoke._check("x", float("nan"), 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SMALL_SINGLE, ids=_id)
def test_single_phase_small_on_gpu(case, gpu):
    """The same small phases compiled for the card (no interpret mode)."""
    phase, sizes = case
    phase(**sizes)
