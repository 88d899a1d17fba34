"""Training: AdamW and the cosine schedule, the LM and SigLIP losses, the
train-step factories and checkpoints in the reference's format."""

from repro_torch.training.optim import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_schedule,
)
from repro_torch.training.trainer import (  # noqa: F401
    TrainHParams,
    make_mem_train_step,
    make_train_step,
)
