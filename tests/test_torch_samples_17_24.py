"""The port's samples 17-24 against the JAX package's, on the CPU (see
``test_torch_samples.py``)."""
import pytest

from test_torch_samples import check_sample, samples


@pytest.mark.parametrize("name", samples(17, 24))
def test_sample_matches_jax(name):
    check_sample(name)
