"""Quantitative evaluation."""

from arl_conditional_normalizing_flows_tpu_torch.evaluation.stats import (  # noqa: F401
    bits_per_dim,
    latent_normality_stats,
    moment_match_report,
    sector_fidelity,
    sr_residual_block_sums,
    y_identity_error,
)
