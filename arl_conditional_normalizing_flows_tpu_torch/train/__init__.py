"""Training: the train state, step functions, the CUDA-graph multi-step,
``fit`` and its metrics."""

from arl_conditional_normalizing_flows_tpu_torch.train.loop import (  # noqa: F401
    FitResult,
    TrainState,
    create_train_state,
    epoch_stacks,
    fit,
    make_scan_train_step,
    make_step_fns,
    noise_batches,
)
from arl_conditional_normalizing_flows_tpu_torch.train.metrics import (  # noqa: F401
    EarlyStopping,
    HistoryLogger,
    MeanMetrics,
)
