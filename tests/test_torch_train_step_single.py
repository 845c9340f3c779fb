"""The port's training step against the JAX package's jitted step on the
single-step branch (``batch_size=64``: no accumulation), on the CPU in fp32,
with the comparison and tolerances of test_torch_train_step.py. A file of its
own, so that its JAX compile (about 80-100 s) runs beside that file's.
"""

from test_torch_train_step import check_steps_against_jax


def test_train_step_matches_jax_single_step_branch():
    """Three applied steps: warmup (weight LR 0 at step 0), its end, after;
    the same variables as the accumulation branch's test."""
    assert check_steps_against_jax(64, warmup_stepnum=1, seed=21) == [True, True, True]
