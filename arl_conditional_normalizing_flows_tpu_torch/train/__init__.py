"""Training: the train state, step functions, the CUDA-graph multi-step,
``fit``, its metrics, and checkpoints."""

from arl_conditional_normalizing_flows_tpu_torch.train.checkpoints import (  # noqa: F401
    CheckpointManager,
    load_npz_extras,
    load_params_npz,
    save_params_npz,
)

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
