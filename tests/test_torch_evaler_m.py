"""tests/test_torch_evaler.py's comparison of the port's Evaler with the JAX
package's, on small M (the CSP graph and the DFL decode), with the same sets
and tolerances. A file of its own, so that its JAX compiles run beside that
file's."""

import pytest

from test_torch_evaler import (  # noqa: F401  (the fixture and the tests run here)
    load_models, sets, test_evaler_matches_jax_on_native_images,
    test_evaler_matches_jax_on_the_jax_loaders_resized_batches,
)


@pytest.fixture(scope="module")
def models(sets, tmp_path_factory):  # noqa: F811
    return load_models("m", sets, tmp_path_factory)
