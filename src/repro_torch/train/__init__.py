from repro_torch.train.step import (TrainState, init_train_state,
                                    make_eval_step, make_train_step,
                                    train_path_summary)

__all__ = ["TrainState", "init_train_state", "make_eval_step",
           "make_train_step", "train_path_summary"]
