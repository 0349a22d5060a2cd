"""The port's lazy gradient penalty (gp_every 2) against txt2vid_tpu's
`build_train_step` on the CPU: step 0 carries the penalty (weight
gp_lambda * gp_every), step 1 skips it. Each port step starts from a file the
JAX package wrote of the JAX state before it, so step 1 also checks that the
restored step counter sets the lazy-GP phase. The harness and tolerances are
test_torch_gp_step's, one intra-op thread with the port's G held to the
float64 step there; step 1, from a trained state, holds the moments to 1e-3
(port) and 2e-3 (JAX) of the leaf scale.
"""

import pytest

from test_torch_gp_step import (_one_torch_thread, check_losses_and_norms,  # noqa: F401
                                check_moments, check_params, run_case)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_case(tmp_path_factory.mktemp("lazy"), "lazy", 2)


@pytest.mark.parametrize("i", [0, 1])
def test_losses_and_norms(runs, i):
    check_losses_and_norms(runs[i])


def test_restored_counter_sets_the_phase(runs):
    """Each port step starts from the file's step counter (0, then 1) and
    ends one past it; the losses above match JAX's on the GP step and on the
    off step, so the restored counter chose the same branch."""
    on, off = runs
    assert on["port"].step == 1 and off["port"].step == 2
    assert "gp_quarantined" not in on["port_metrics"]


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("side", ["G", "D"])
@pytest.mark.parametrize("which", ["mu", "nu"])
def test_adam_moments(runs, i, side, which):
    check_moments(runs[i], side, which, tols=(1e-4, 5e-4) if i == 0 else (1e-3, 2e-3))


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("side", ["G", "D"])
def test_params_after_step(runs, i, side):
    check_params(runs[i], side)
