"""Training library of the port: the train step, the sharded state, the
optimizer and the losses (port of ``k8s_tpu/train``)."""

from k8s_tpu_torch.train.trainer_lib import (  # noqa: F401
    ShardedLayout,
    TrainState,
    adamw,
    create_sharded_state,
    create_train_state,
    cross_entropy_loss,
    init_optimizer_state,
    load_state_tree,
    make_batch_sharder,
    make_eval_step,
    make_train_step,
    sequence_mean,
    sgd,
    state_tree,
)
