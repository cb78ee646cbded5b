"""K4's plain version against the JAX fused backward for the
deterministic menu pairs (soft, affine and hard coverage), with the
tolerances of test_torch_backward.py."""

import pytest

from _torch_parity import interpret_env, one_torch_thread  # noqa: F401
from test_torch_backward import check_menu_pair

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    interpret_env(monkeypatch)


@pytest.mark.parametrize("noise", ["softras", "uniform", "hard"])
def test_backward_plain_matches_jax_menu_deterministic(noise):
    check_menu_pair(noise)
