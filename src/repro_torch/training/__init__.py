from repro_torch.training.steps import (  # noqa: F401
    loss_and_grads, make_train_step, make_train_step_ddp, softmax_xent)
