"""Data sources: image datasets, the class-conditional and the
super-resolution batch sources."""

from arl_conditional_normalizing_flows_tpu_torch.data import images  # noqa: F401
