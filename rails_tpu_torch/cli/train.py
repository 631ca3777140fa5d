"""`--set section.field=value` overrides of an experiment config.

Counterpart of `apply_override` in `rails_tpu/cli/train.py:28-49`; the rest
of that CLI (the training run itself) is not ported yet (ROADMAP.md, Queue 1:
the training CLI).
"""

from __future__ import annotations

import ast
import dataclasses

from rails_tpu_torch.core.config import ExperimentConfig


def apply_override(cfg: ExperimentConfig, dotted: str, raw_value: str) -> ExperimentConfig:
    """Apply `section.field=value`, the value parsed as a Python literal.

    `true`/`false` in any case parse as booleans (the string "false" is
    truthy); a value that is no literal stays a string."""
    low = raw_value.strip().lower()
    if low in ("true", "false"):
        value = low == "true"
    else:
        try:
            value = ast.literal_eval(raw_value)
        except (ValueError, SyntaxError):
            value = raw_value

    def rec(obj, path):
        if len(path) == 1:
            return dataclasses.replace(obj, **{path[0]: value})
        return dataclasses.replace(obj, **{path[0]: rec(getattr(obj, path[0]), path[1:])})

    return rec(cfg, dotted.split("."))
