"""Utilities."""

from arl_conditional_normalizing_flows_tpu_torch.utils.run_metadata import (  # noqa: F401
    write_run_metadata,
)
