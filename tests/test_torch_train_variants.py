"""Three training steps of the port against the JAX package
(tests/test_torch_train.py's check) on the plain scan path and with the
firing-rate regularizers, whose cotangent reaches the fused cell's
backward as a broadcast from the firing-rate mean. A file of its own so
that the two run beside the main case."""
import pytest

from tests.test_torch_train import REG, check_three_train_steps


@pytest.mark.parametrize(
    "cell_impl,reg", [("scan", None), ("pallas", REG)],
    ids=["scan", "pallas-regularizers"],
)
def test_three_train_steps_match_jax_variant(cell_impl, reg):
    check_three_train_steps(cell_impl, reg)
