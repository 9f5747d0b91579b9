from .checkpoint import (save, save_async, restore, latest_step,
                         wait_pending, save_train_state, restore_train_state)
