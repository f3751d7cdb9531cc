"""Change scoring: the eval loop and its change maps (counterpart of
`flowcompare_tpu/eval/__init__.py`)."""

from .evaluate import calc_change, clamp_infs, evaluate_on_test, log_prob_to_change

__all__ = ["calc_change", "clamp_infs", "evaluate_on_test", "log_prob_to_change"]
