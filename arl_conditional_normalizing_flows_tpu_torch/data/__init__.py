"""Data sources: image datasets and the class-conditional batch source."""

from arl_conditional_normalizing_flows_tpu_torch.data import images  # noqa: F401
