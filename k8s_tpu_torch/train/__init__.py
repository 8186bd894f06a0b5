"""Training library of the port: the single-device train step, the
optimizer and the losses (port of ``k8s_tpu/train``)."""

from k8s_tpu_torch.train.trainer_lib import (  # noqa: F401
    TrainState,
    adamw,
    create_train_state,
    cross_entropy_loss,
    init_optimizer_state,
    load_state_tree,
    make_train_step,
    state_tree,
)
