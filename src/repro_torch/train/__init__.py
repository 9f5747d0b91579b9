from .optimizer import make_optimizer, lr_schedule
from .loop import make_train_step, lm_loss, Trainer
