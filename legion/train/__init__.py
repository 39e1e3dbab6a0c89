from legion.train.train_state import TrainState, create_train_state  # noqa: F401
from legion.train.loop import Trainer  # noqa: F401
